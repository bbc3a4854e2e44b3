"""Host-side helpers, checkpoints, weight conversion, quantization, stream
merging and profiling."""

from icafusion_tpu_torch.utils.general import (check_img_size, colorstr,
                                               make_divisible, one_cycle)

__all__ = ["make_divisible", "check_img_size", "one_cycle", "colorstr"]
