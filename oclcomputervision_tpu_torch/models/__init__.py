"""The RAISR filter bank (``RaisrModel``, its trainer ``train_filters``) and
the enhancement pipeline (``EnhancePipeline``)."""

from oclcomputervision_tpu_torch.models.pipeline import EnhanceConfig, EnhancePipeline
from oclcomputervision_tpu_torch.models.raisr import RaisrModel, train_filters

__all__ = ["EnhanceConfig", "EnhancePipeline", "RaisrModel", "train_filters"]
