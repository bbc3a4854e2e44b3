"""Evaluation: AP metrics and the Evaluator."""

from icafusion_tpu_torch.eval.evaluator import Evaluator
from icafusion_tpu_torch.eval.metrics import ap_per_class, compute_ap, fitness

__all__ = ["ap_per_class", "compute_ap", "fitness", "Evaluator"]
