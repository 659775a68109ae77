"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| kernel (csrc/)         | wrapper                                  | replaces (ops/pallas/)                 |
|------------------------|------------------------------------------|----------------------------------------|
| ``upscale_planes.cu``  | ``upscale.upscale_planes_kernel``        | ``upscale_pallas.upscale_planes_pallas`` |
| ``raisr_hash.cu``      | ``raisr.hash_planes_kernel``             | ``raisr_pallas.hash_planes_pallas``    |
| ``raisr_apply.cu``     | ``raisr.apply_filters_planes_kernel``    | ``raisr_pallas.apply_filters_planes``  |

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, counting the launch in ``_build.LAUNCHES``.
"""
