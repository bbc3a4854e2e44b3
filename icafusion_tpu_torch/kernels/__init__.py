"""The hand-written CUDA kernels' wrappers (each with its plain version)."""

from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention

__all__ = ["dual_cross_attention"]
