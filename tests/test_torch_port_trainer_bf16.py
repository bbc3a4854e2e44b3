"""One bf16 Trainer step of icafusion_tpu_torch (autocast to bfloat16 over
float32 parameters; LayerNorm, the attention softmax and the loss in
float32) against the JAX Trainer's bf16 step (its modules computing in
bfloat16 over float32 parameters), dropout off, on the CPU.

The two round at different points (autocast keeps BatchNorm's statistics
and the attention logits in float32 where flax rounds some products to
bfloat16), so the step is held loosely: loss and items within 2e-2
relative."""

import jax.numpy as jnp
import pytest
import torch

from torch_port_common import nchw, tiny_trainers, train_batch

torch.set_num_threads(1)

BF16_RTOL = 2e-2


def test_bf16_step_matches_jax_bf16_step():
    jtr, state, jstep, tr, _ = tiny_trainers(2, bf16=True)
    data = train_batch(2)
    _, want = jstep(state, *(jnp.asarray(a) for a in data))
    got = tr.make_train_step()(nchw(data[0]), nchw(data[1]),
                               torch.from_numpy(data[2]),
                               torch.from_numpy(data[3]))
    for k in ("loss", "lbox", "lobj", "lcls"):
        assert float(got[k]) == pytest.approx(float(want[k]),
                                              rel=BF16_RTOL), k
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(v.dtype == torch.float32 for v in tr.ema.tree.values())
