"""Box geometry and NMS (the JAX package's ops/__init__.py names)."""

from icafusion_tpu_torch.ops.boxes import (bbox_iou, box_iou, clip_coords,
                                           scale_coords, xywh2xyxy,
                                           xyxy2xywh)
from icafusion_tpu_torch.ops.nms import batched_nms, non_max_suppression

__all__ = ["xywh2xyxy", "xyxy2xywh", "bbox_iou", "box_iou", "clip_coords",
           "scale_coords", "batched_nms", "non_max_suppression"]
