"""Paired datasets, their loader, decoding and dataset tools."""

from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
from icafusion_tpu_torch.data.loader import PairedLoader

__all__ = ["PairedDetectionDataset", "PairedLoader"]
