"""Image IO, asset paths, PSNR and timing."""

from oclcomputervision_tpu_torch.utils.assets import asset_path
from oclcomputervision_tpu_torch.utils.metrics import psnr
from oclcomputervision_tpu_torch.utils.png import gray, load_gray, load_image, read_png
from oclcomputervision_tpu_torch.utils.profiling import cuda_time_ms, device_profile

__all__ = [
    "asset_path",
    "cuda_time_ms",
    "device_profile",
    "gray",
    "load_gray",
    "load_image",
    "psnr",
    "read_png",
]
