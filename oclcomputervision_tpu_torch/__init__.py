"""PyTorch / CUDA port of oclcomputervision_tpu for one NVIDIA H100.

The JAX package beside this one is the reference: every stage here is held
against it on the CPU, and every hand-written CUDA kernel is held against its
plain PyTorch version on the card.

Layers (counterparts of the JAX package's modules of the same names):

- ``kernels``: hand-written CUDA C++ kernels for Hopper (``kernels/csrc``),
  built with nvcc and bound with ctypes, each beside its plain PyTorch version.
- ``ops``: plain PyTorch pipelines around the kernels (RAISR inference,
  global and local-block histogram equalization).
- ``models``: ``RaisrModel``, the filter bank as an ``nn.Module``, its
  trainer and ``EnhancePipeline``.
- ``parallel``: the sharding strategies on ``torch.distributed`` (a mesh
  over the process group, row-sharded histeq, motion and RAISR, the dp + tp
  RAISR train step) and ``parallel.launch``, which starts the ranks.
- ``utils``: configs, asset paths, PSNR, MAE, EPE, a stdlib PNG reader and
  writer, and timing (CUDA events, wall times that end in a synchronise,
  torch.profiler).
- ``oracle``: the numpy oracles (histeq, interpolation, RAISR).

Entry points run on the card unless the caller passes ``device="cpu"``; a
torch tensor input runs on its own device. Nothing picks the CPU by itself.
This package imports neither JAX nor the JAX package: it keeps its own
copies of the configs, asset paths, PSNR and numpy oracles it needs
(``utils.config``, ``utils.assets``, ``utils.metrics``, ``oracle``).
"""

from oclcomputervision_tpu_torch._device import require_cuda

__all__ = ["require_cuda"]
