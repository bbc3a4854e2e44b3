"""Shared helpers of the tests that hold icafusion_tpu_torch against the JAX
package: random flax variables from a numpy seed and layout moves."""

import numpy as np
import torch

import jax


def random_variables(module, *args, seed: int = 0, **kwargs):
    """{"params", "batch_stats"} for a flax module as nested dicts of numpy
    arrays drawn from ``seed``, scaled so that every parameter matters:
    He-normal kernels, BatchNorm statistics away from identity, non-zero
    positional embeddings and gains near their inits."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("scale", "coefficients"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("w1", "w2"):
            v = 0.5 + 0.1 * rng.normal(size=shape)
        else:                   # bias, mean, pos_emb_*
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    tree = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    return jax.tree_util.tree_map_with_path(draw, tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
