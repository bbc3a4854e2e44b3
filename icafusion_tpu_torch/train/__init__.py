"""Training: the loss, the Trainer, fit and hyperparameter evolution."""

from icafusion_tpu_torch.train.loss import YoloLoss

__all__ = ["YoloLoss"]
