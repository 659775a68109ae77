"""Image and flow IO, asset paths, PSNR, MAE, EPE and timing."""

from oclcomputervision_tpu_torch.utils.assets import asset_path
from oclcomputervision_tpu_torch.utils.flo import read_flo, write_flo
from oclcomputervision_tpu_torch.utils.metrics import epe, mae, psnr
from oclcomputervision_tpu_torch.utils.png import (
    gray,
    gray_libpng,
    load_gray,
    load_image,
    read_png,
    write_png,
)
from oclcomputervision_tpu_torch.utils.profiling import (
    Timer,
    cuda_time_ms,
    device_profile,
    timed,
)

__all__ = [
    "Timer",
    "asset_path",
    "cuda_time_ms",
    "device_profile",
    "epe",
    "gray",
    "gray_libpng",
    "load_gray",
    "load_image",
    "mae",
    "psnr",
    "read_flo",
    "read_png",
    "timed",
    "write_flo",
    "write_png",
]
