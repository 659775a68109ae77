"""Image and flow IO, asset paths, PSNR, EPE and timing."""

from oclcomputervision_tpu_torch.utils.assets import asset_path
from oclcomputervision_tpu_torch.utils.flo import read_flo, write_flo
from oclcomputervision_tpu_torch.utils.metrics import epe, psnr
from oclcomputervision_tpu_torch.utils.png import (
    gray,
    gray_libpng,
    load_gray,
    load_image,
    read_png,
)
from oclcomputervision_tpu_torch.utils.profiling import cuda_time_ms, device_profile, timed

__all__ = [
    "asset_path",
    "cuda_time_ms",
    "device_profile",
    "epe",
    "gray",
    "gray_libpng",
    "load_gray",
    "load_image",
    "psnr",
    "read_flo",
    "read_png",
    "timed",
    "write_flo",
]
