"""The two-stream model: assembly from the YAML layers and Detect."""

from icafusion_tpu_torch.models.assembler import (ICAFusionModel, build_model,
                                                  resolve_model)
from icafusion_tpu_torch.models.detect import Detect

__all__ = ["ICAFusionModel", "build_model", "resolve_model", "Detect"]
