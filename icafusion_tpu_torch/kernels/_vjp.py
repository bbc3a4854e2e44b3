"""The backward of the float kernels: the vjp of their plain versions.

No TPU kernel of the JAX package has a backward kernel of its own (JAX
differentiates the function the kernel computes), so a wrapper's
``torch.autograd.Function`` recomputes the plain PyTorch version on the
inputs it saved and returns its gradients.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def plain_vjp(plain: Callable, saved: Sequence[torch.Tensor],
              needs: Sequence[bool], grads: Sequence[torch.Tensor]) -> list:
    """Gradients of ``plain(*saved)`` for each saved input whose ``needs``
    is true (None for the others), given the output gradients ``grads``
    (None for an output without one)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True) if wrt and pairs
                   else [None] * len(wrt))
    return [next(got) if t.requires_grad else None for t in ins]
