"""Experiment logging: TensorBoard scalars and images where a writer
imports.

Counterpart of the JAX package's utils/loggers.py (reference train.py:586
SummaryWriter). results.csv is written by train/fit.py itself; this facade
adds the TensorBoard channel through torch.utils.tensorboard (which needs
the ``tensorboard`` package), imported when a writer is made. Where it
does not import, ``tb`` is None and every call is a no-op. The remote
logger of the reference (wandb, forced offline there) has no counterpart.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


class Loggers:
    def __init__(self, run_dir, enable_tb: bool = True):
        self.run_dir = Path(run_dir)
        self.tb = self._make_tb_writer() if enable_tb else None

    def _make_tb_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(str(self.run_dir / "tb"))

    def log_scalars(self, scalars: Dict[str, float], step: int):
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def log_image(self, tag: str, img, step: int):
        """img: HWC (1 or 3 channels) or CHW."""
        if self.tb is not None:
            arr = np.asarray(img)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                arr = arr.transpose(2, 0, 1)
            self.tb.add_image(tag, arr, step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
