"""Model EMA with the warmup-ramped decay (reference
utils/torch_utils.py:279-313, the JAX package's train/ema.py):
d = base * (1 - exp(-updates / 2000)), over the parameters and the
BatchNorm statistics, kept in float32 whatever the compute dtype."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    tree: Dict[str, torch.Tensor]   # state-dict name -> float32 shadow
    updates: int = 0


def ema_variables(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The state the EMA tracks: every parameter and BatchNorm statistic
    (``num_batches_tracked`` is a counter, not a statistic)."""
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def ema_init(variables: Mapping[str, torch.Tensor]) -> EmaState:
    return EmaState(tree={k: v.detach().float().clone()
                          for k, v in variables.items()})


@torch.no_grad()
def ema_update(state: EmaState, variables: Mapping[str, torch.Tensor],
               base_decay: float = 0.9999) -> EmaState:
    """e = d * e + (1 - d) * v, in place; d computed in float32."""
    state.updates += 1
    f = np.float32
    d = f(base_decay) * (f(1) - np.exp(-f(state.updates) / f(2000)))
    names = list(state.tree)
    es = [state.tree[k] for k in names]
    vs = [variables[k].detach().float() for k in names]
    torch._foreach_mul_(es, float(d))
    torch._foreach_add_(es, vs, alpha=float(f(1) - d))
    return state
