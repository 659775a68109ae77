"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| kernel (csrc/)         | wrapper                                  | replaces (ops/pallas/)                 |
|------------------------|------------------------------------------|----------------------------------------|
| ``upscale_planes.cu``  | ``upscale.upscale_planes_kernel``        | ``upscale_pallas.upscale_planes_pallas`` |
| ``raisr_hash.cu``      | ``raisr.hash_planes_kernel``             | ``raisr_pallas.hash_planes_pallas``    |
| ``raisr_apply.cu``     | ``raisr.apply_filters_planes_kernel``    | ``raisr_pallas.apply_filters_planes``  |
| ``raisr_hash_generic.cu``, ``raisr_apply_generic.cu`` | the same two, for configs outside the compiled forms | the same two |
| ``hist256.cu``         | ``histeq.hist256_kernel``                | ``histeq_pallas.hist256_pallas``       |
| ``apply_lut.cu``       | ``histeq.apply_lut_kernel``              | ``histeq_pallas.apply_lut_pallas``     |
| ``hist_tiles.cu``      | ``localeq.hist_tiles_kernel``            | ``localeq_pallas.hist_tiles_pallas``   |
| ``blend_blocks.cu``    | ``localeq.blend_blocks_kernel``          | ``localeq_pallas._blend_blocks`` and ``_blend_tiles`` |
| ``me_exact.cu``        | ``motion.me_exact_kernel``               | ``me_pallas.me_exact_pallas`` and ``_seeded_impl`` |
| ``me_fast_round.cu``, ``me_fast_median.cu`` | ``motion.me_fast_kernel`` (``fast_round_kernel``: one round) | ``me_fast_pallas.me_fast_residual_pallas`` |
| ``resize_sep.cu``      | ``resize.resize_sep`` (through ``ops.interpolation._resize_plane``) | none: the JAX resize is plain jnp |

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, counting the launch in ``_build.LAUNCHES`` (the resize
makes that choice in ``ops.interpolation._resize_plane``). ``forms`` times
alternative sources of a kernel against each other on the card.
"""
