"""Model assembly: a YAML layer list -> the two-stream torch module.

Counterpart of the JAX package's models/assembler.py (reference
models/yolo_test.py:115-163 forward_once, :216-302 parse_model):

- ``resolve_model`` infers every layer's channels, with depth_multiple and
  width_multiple scaling, and the save-list of outputs later layers read;
- a layer with ``from: -4`` reads the second (IR) image, so the layers
  before the first fusion form two independent towers;
- modules come from a registry (``MODULE_BUILDERS``) instead of eval().

This slice registers the modules of the serving and training paths: Conv,
Bottleneck, C3, SPPF, Focus, Concat, Upsample, TransformerFusionBlock and
Detect. Layers are registered as ``m{i}``, the flax names.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from icafusion_tpu_torch.config import FromSpec, ModelConfig
from icafusion_tpu_torch.models.detect import (Detect, check_anchor_order,
                                               default_strides)
from icafusion_tpu_torch.nn import fusion, layers
from icafusion_tpu_torch.utils.general import make_divisible

# first two resolved args are (c1, c2); c2 is width-scaled
_CONV_LIKE = {"Conv", "Bottleneck", "SPPF", "Focus", "C3"}
# modules that take the repeat count as an inner depth argument
_ABSORB_N = {"C3"}

MODULE_BUILDERS = {
    "Conv": lambda a: layers.Conv(*a),
    "Bottleneck": lambda a: layers.Bottleneck(*a),
    "C3": lambda a: layers.C3(*a),
    "SPPF": lambda a: layers.SPPF(*a),
    "Focus": lambda a: layers.Focus(*a),
    "Concat": lambda a: layers.Concat(a[0] if a else 1),
    "Upsample": lambda a: layers.Upsample(
        a[0], a[1] if len(a) > 1 else None, a[2] if len(a) > 2 else "nearest"),
    "TransformerFusionBlock": lambda a: fusion.TransformerFusionBlock(
        d_model=a[0], vert_anchors=a[1], horz_anchors=a[2]),
    "Detect": lambda a: Detect(*a),
}


@dataclasses.dataclass(frozen=True)
class ResolvedLayer:
    i: int
    f: FromSpec            # -1 previous, -4 IR input, else absolute index(es)
    n: int                 # repeats (1 once absorbed)
    module: str
    args: Tuple[Any, ...]  # resolved constructor args
    c2: int                # output channels


def _abs_from(f: FromSpec, i: int) -> FromSpec:
    def one(x: int) -> int:
        return x if x in (-1, -4) or x >= 0 else x % i
    return tuple(one(x) for x in f) if isinstance(f, tuple) else one(f)


@functools.lru_cache(maxsize=16)
def resolve_model(cfg: ModelConfig) -> Tuple[Tuple[ResolvedLayer, ...],
                                             frozenset]:
    """Channel inference over the flattened layer list (parse_model)."""
    missing = {l.module for l in cfg.layers} - set(MODULE_BUILDERS)
    if missing:
        raise ValueError(f"config {cfg.name}: modules {sorted(missing)} are "
                         "not ported")
    gd, gw = cfg.depth_multiple, cfg.width_multiple
    in_ch = cfg.ch
    ch: List[int] = [in_ch]
    resolved: List[ResolvedLayer] = []
    save: set = set()
    for ld in cfg.layers:
        i, f, m = ld.i, _abs_from(ld.f, ld.i), ld.module
        args = list(ld.args)
        n = max(round(ld.n * gd), 1) if ld.n > 1 else ld.n

        def src_ch(j: int) -> int:
            return in_ch if j == -4 else ch[j]

        if m in _CONV_LIKE:
            c1 = in_ch if (m == "Focus" or f == -4 or i == 0) else src_ch(f)
            c2 = args[0]
            if c2 != cfg.no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c1, c2, *args[1:]]
            if m in _ABSORB_N:
                args.insert(2, n)
                n = 1
        elif m == "Concat":
            c2 = sum(src_ch(x) for x in f)
        elif m == "Detect":
            args.append(tuple(src_ch(x) for x in f))
            c2 = -1
        elif m == "TransformerFusionBlock":
            c2 = src_ch(f[0])
            args = [c2, *args[1:]]
        else:
            c2 = src_ch(f) if isinstance(f, int) else src_ch(f[0])
        if n > 1:
            raise ValueError(f"layer {i}: {m} repeated {n} times is not "
                             "ported")
        resolved.append(ResolvedLayer(i=i, f=f, n=n, module=m,
                                      args=tuple(args), c2=c2))
        for x in (f if isinstance(f, tuple) else (f,)):
            if x not in (-1, -4):
                save.add(x)
        if i == 0:
            ch = []
        ch.append(c2)
    return tuple(resolved), frozenset(save)


class ICAFusionModel(nn.Module):
    """The two-stream detector: forward(rgb, ir) with NCHW float images
    returns, in eval mode, the decoded predictions (B, N, 5 + nc) in
    float32 and, in train mode, Detect's raw maps per level. It is built in
    eval mode."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.resolved, self.save = resolve_model(cfg)
        for r in self.resolved:
            self.add_module(f"m{r.i}", MODULE_BUILDERS[r.module](r.args))
        self.train(False)

    def cast(self, dtype: torch.dtype) -> "ICAFusionModel":
        """Cast the parameters in place to a compute dtype, the way the JAX
        modules cast their float32 parameters at use. LayerNorm and
        BatchNorm parameters stay float32, and so do the six attention
        projection biases (the fused kernel adds them in float32). Buffers
        (BatchNorm statistics, Detect's anchors) stay float32."""
        keep = set()
        for m in self.modules():
            if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                keep |= {id(p) for p in m.parameters(recurse=False)}
            elif isinstance(m, fusion.CrossAttention):
                keep |= {id(getattr(m, n).bias) for n in fusion.NAMES}
        for p in self.parameters():
            if id(p) not in keep:
                p.data = p.data.to(dtype)
        return self

    def forward(self, x, x2=None):
        y: Dict[int, Any] = {}
        out = x
        x2 = x if x2 is None else x2
        for r in self.resolved:
            if r.f == -4:
                inp = x2
            elif r.f == -1:
                inp = out
            elif isinstance(r.f, int):
                inp = y[r.f]
            else:
                inp = [out if j == -1 else y[j] for j in r.f]
            out = getattr(self, f"m{r.i}")(inp)
            if r.i in self.save:
                y[r.i] = out
        return out


def detect_layer(cfg: ModelConfig) -> ResolvedLayer:
    resolved, _ = resolve_model(cfg)
    if resolved[-1].module != "Detect":
        raise ValueError(f"config {cfg.name}: the last layer must be Detect")
    return resolved[-1]


def model_strides(cfg: ModelConfig) -> Tuple[int, ...]:
    return default_strides(len(detect_layer(cfg).args[1]))


def anchors_grid_units(cfg: ModelConfig) -> np.ndarray:
    """(nl, na, 2) anchors in grid units (pixels / stride), in the
    stride-checked order, as the loss takes them (yolo_test.py:105)."""
    _, anchors, _ = detect_layer(cfg).args
    strides = default_strides(len(anchors))
    a = np.asarray(anchors, np.float32).reshape(len(anchors), -1, 2)
    return (check_anchor_order(a, strides)
            / np.asarray(strides, np.float32).reshape(-1, 1, 1))


def init_weights(model: ICAFusionModel,
                 generator: Optional[torch.Generator] = None) -> ICAFusionModel:
    """Draw ``model``'s parameters anew from the distributions of the JAX
    package's initialisers, for training from scratch: every conv kernel
    U(+-1/sqrt(fan_in)) (its TORCH_CONV_INIT, torch's default), Detect's
    biases U(+-1/sqrt(c_in)); the attention projections N(0, 0.001) with
    zero biases; the MLP kernels U(+-1/sqrt(fan_in)) with zero biases;
    norms at scale 1, bias 0 and BatchNorm statistics at mean 0, var 1;
    the residual gains 1, the pooling blend 0.5 and 0.5, the positional
    embeddings 0. (build_model's He-uniform draw is for serving.)"""
    from icafusion_tpu_torch.nn import fusion as fu
    init = nn.init
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                init.uniform_(m.weight, -bound, bound, generator=generator)
                if m.bias is not None:
                    init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, fu.CrossAttention):
                for name in fu.NAMES + ("out_vis", "out_ir"):
                    lin = getattr(m, name)
                    init.normal_(lin.weight, 0.0, 0.001, generator=generator)
                    init.zeros_(lin.bias)
            elif isinstance(m, fu.CrossTransformerBlock):
                for name in ("mlp_vis_fc1", "mlp_vis_fc2", "mlp_ir_fc1",
                             "mlp_ir_fc2"):
                    lin = getattr(m, name)
                    bound = 1.0 / math.sqrt(lin.in_features)
                    init.uniform_(lin.weight, -bound, bound,
                                  generator=generator)
                    init.zeros_(lin.bias)
                init.ones_(m.coefficients)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                init.ones_(m.weight)
                init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            elif isinstance(m, fu.LearnableWeights):
                init.constant_(m.w1, 0.5)
                init.constant_(m.w2, 0.5)
            elif isinstance(m, fu.TransformerFusionBlock):
                init.zeros_(m.pos_emb_vis)
                init.zeros_(m.pos_emb_ir)
    return model


def build_model(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None) -> ICAFusionModel:
    """The model in float32. With ``generator``, every conv and linear layer
    is drawn anew from it, weights He-uniform (kaiming_uniform, a=0) so that
    activations keep their scale through the towers and the random model's
    outputs vary with its input, biases U(+-1/sqrt(fan_in)); the weights then
    depend on the generator's seed alone. The other parameters keep their
    constructor values."""
    model = ICAFusionModel(cfg)
    if generator is not None:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    nn.init.kaiming_uniform_(m.weight, a=0.0,
                                             generator=generator)
                    if m.bias is not None:
                        bound = 1.0 / math.sqrt(m.weight[0].numel())
                        nn.init.uniform_(m.bias, -bound, bound,
                                         generator=generator)
    return model
