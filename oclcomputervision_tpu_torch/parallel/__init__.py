"""Multi-process scaling on ``torch.distributed`` (``parallel/mesh.py``), and
``parallel/launch.py``, which starts the ranks."""

from oclcomputervision_tpu_torch.parallel.mesh import (
    data_parallel,
    histeq_global_sharded,
    histeq_local_sharded,
    make_mesh,
    motion_exact_sharded,
    motion_fast_sharded,
    raisr_train_step,
    raisr_upsample_sharded,
)

__all__ = [
    "make_mesh",
    "data_parallel",
    "histeq_global_sharded",
    "histeq_local_sharded",
    "motion_exact_sharded",
    "motion_fast_sharded",
    "raisr_train_step",
    "raisr_upsample_sharded",
]
