"""Model assembly: a YAML layer list -> the two-stream torch module.

Counterpart of the JAX package's models/assembler.py (reference
models/yolo_test.py:115-163 forward_once, :216-302 parse_model):

- ``resolve_model`` infers every layer's channels, with depth_multiple and
  width_multiple scaling, and the save-list of outputs later layers read;
- a layer with ``from: -4`` reads the second (IR) image, so the layers
  before the first fusion form two independent towers;
- modules come from a registry (``MODULE_BUILDERS``, every name of the
  JAX package's) instead of eval(); a module missing from it raises "not
  ported". A row repeated n > 1 times whose module does not take n itself
  becomes a ``Repeat`` of n copies. Layers are registered as ``m{i}``,
  the flax names.
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
from icafusion_tpu_torch.nn import backbones, fusion, layers
from icafusion_tpu_torch.utils.general import make_divisible

# first two resolved args are (c1, c2); c2 is width-scaled
_CONV_LIKE = {"Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
              "SPPF", "DWConv", "MixConv2d", "Focus", "CrossConv",
              "BottleneckCSP", "C3", "C3TR"}
# modules that take the repeat count as an inner depth argument
_ABSORB_N = {"BottleneckCSP", "C3", "C3TR"}

MODULE_BUILDERS = {
    "Conv": lambda a: layers.Conv(*a),
    "DWConv": lambda a: layers.DWConv(*a),
    "Bottleneck": lambda a: layers.Bottleneck(*a),
    "BottleneckCSP": lambda a: layers.BottleneckCSP(*a),
    "C3": lambda a: layers.C3(*a),
    "C3TR": lambda a: layers.C3TR(*a),
    "SPP": lambda a: layers.SPP(a[0], a[1],
                                tuple(a[2]) if len(a) > 2 else (5, 9, 13)),
    "SPPF": lambda a: layers.SPPF(*a),
    "Focus": lambda a: layers.Focus(*a),
    "CrossConv": lambda a: layers.CrossConv(*a),
    "GhostConv": lambda a: layers.GhostConv(*a),
    "GhostBottleneck": lambda a: layers.GhostBottleneck(*a),
    "MixConv2d": lambda a: layers.MixConv2d(
        a[0], a[1], tuple(a[2]) if len(a) > 2 else (1, 3),
        a[3] if len(a) > 3 else 1),
    "Contract": lambda a: layers.Contract(a[0]),
    "Expand": lambda a: layers.Expand(a[0]),
    "Concat": lambda a: layers.Concat(a[0] if a else 1),
    "Upsample": lambda a: layers.Upsample(
        a[0], a[1] if len(a) > 1 else None, a[2] if len(a) > 2 else "nearest"),
    "BatchNorm2d": lambda a: layers.BatchNormLayer(a[0]),
    "MaxPool2d": lambda a: layers.MaxPool2d(a[0], a[1] if len(a) > 1
                                            else a[0]),
    "SE_Block": lambda a: layers.SE_Block(*a),
    "CBAM": lambda a: layers.CBAM(*a),
    "Channel_Attention": lambda a: layers.ChannelAttention(*a),
    "Spatial_Attention": lambda a: layers.SpatialAttention(*a),
    "Classify": lambda a: layers.Classify(*a),
    "TransformerFusionBlock": lambda a: fusion.TransformerFusionBlock(
        d_model=a[0], vert_anchors=a[1], horz_anchors=a[2]),
    "Add": lambda a: fusion.Add(),
    "Add2": lambda a: fusion.Add2(a[1]),
    "NiNfusion": lambda a: fusion.NiNfusion(a[0], a[1]),
    "DMAF": lambda a: fusion.DMAF(),
    "VGGblock": lambda a: backbones.VGGblock(*a),
    "ResNetblock": lambda a: backbones.ResNetblock(*a),
    "ResNetlayer": lambda a: backbones.ResNetlayer(*a),
    "Detect": lambda a: Detect(*a),
}


class Repeat(nn.Module):
    """n independent copies of a module applied in turn, r0..r{n-1} (the
    JAX package's _Repeat; reference parse_model's nn.Sequential for a
    repeated row that does not take n itself, yolo_test.py:290)."""

    def __init__(self, module: str, args: Tuple[Any, ...], n: int):
        super().__init__()
        self.n = n
        for j in range(n):
            self.add_module(f"r{j}", MODULE_BUILDERS[module](args))

    def forward(self, x):
        for j in range(self.n):
            x = getattr(self, f"r{j}")(x)
        return x


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
        elif m == "ResNetlayer":     # args carry c1: [c1, c2, s, first, n]
            c2 = args[1] if args[3] else 4 * args[1]
        elif m == "VGGblock":        # [num_convs, c1, c2]
            c2 = args[2]
        elif m == "BatchNorm2d":
            c2 = src_ch(f)
            args = [c2]
        elif m == "Concat":
            c2 = sum(src_ch(x) for x in f)
        elif m in ("Add", "DMAF"):
            c2 = src_ch(f[0])
            args = [c2]
        elif m == "Add2":
            c2 = src_ch(f[0])
            args = [c2, args[1]]
        elif m == "NiNfusion":
            c1 = sum(src_ch(x) for x in f)
            c2 = c1 // 2
            args = [c1, c2, *args]
        elif m == "Detect":
            args.append(tuple(src_ch(x) for x in f))
            c2 = -1
        elif m == "Contract":
            c2 = src_ch(f) * args[0] ** 2
        elif m == "Expand":
            c2 = src_ch(f) // args[0] ** 2
        elif m == "TransformerFusionBlock":
            c2 = src_ch(f[0])
            args = [c2, *args[1:]]
        else:
            c2 = src_ch(f) if isinstance(f, int) else src_ch(f[0])
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
    float32 (with raw=True, and Detect's raw maps) and, in train mode,
    Detect's raw maps per level. It is built in eval mode."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.resolved, self.save = resolve_model(cfg)
        for r in self.resolved:
            self.add_module(f"m{r.i}", Repeat(r.module, r.args, r.n)
                            if r.n > 1 and r.module != "Detect"
                            else MODULE_BUILDERS[r.module](r.args))
        self.train(False)

    def cast(self, dtype: torch.dtype) -> "ICAFusionModel":
        """Cast the parameters in place to a compute dtype, the way the JAX
        modules cast their float32 parameters at use (flax's ``dtype=``):
        conv and linear weights and biases (VGG's and NiNfusion's convs
        too) take it. LayerNorm and BatchNorm parameters (ResNet's
        included) stay float32, and so do the six attention projection
        biases (the fused kernel adds them in float32). Buffers (BatchNorm
        statistics, Detect's anchors, and the int8 path's ``w8`` in int8
        with its ``s_in`` and ``s_w`` in float32) keep their dtypes."""
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

    def forward(self, x, x2=None, raw: bool = False):
        """raw (eval mode): return (decoded predictions, Detect's raw maps
        per level), for a loss on the same forward."""
        y: Dict[int, Any] = {}
        out = x
        x2 = x if x2 is None else x2
        last = self.resolved[-1].i
        for r in self.resolved:
            if r.f == -4:
                inp = x2
            elif r.f == -1:
                inp = out
            elif isinstance(r.f, int):
                inp = y[r.f]
            else:
                inp = [out if j == -1 else y[j] for j in r.f]
            m = getattr(self, f"m{r.i}")
            out = m(inp, raw=True) if raw and r.i == last else m(inp)
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
    and VGG's conv biases U(+-1/sqrt(fan_in)) (torch_bias_init); the
    attention projections N(0, 0.001) with zero biases; the MLP kernels U(+-1/sqrt(fan_in)) with zero biases;
    norms at scale 1, bias 0 and BatchNorm statistics at mean 0, var 1;
    the residual gains 1, the pooling blend 0.5 and 0.5, the positional
    embeddings 0; in the legacy modules, the layers flax leaves at its
    default init lecun normal with zero biases. (build_model's He-uniform
    draw is for serving.)"""
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
        # the legacy modules' layers that keep flax's default init in the
        # JAX package (its Dense, DenseGeneral and bare Conv without
        # kernel_init): lecun normal kernels, zero biases
        for m in model.modules():
            if isinstance(m, _FLAX_DEFAULT_INIT):
                for c in m.children():
                    if isinstance(c, (nn.Conv2d, nn.Linear,
                                      layers.DenseGeneral)):
                        _lecun_normal(c, generator)
    return model


_FLAX_DEFAULT_INIT = (layers.MultiHeadDotProductAttention,
                      layers.TransformerLayer, layers.TransformerBlock,
                      layers.MixConv2d, layers.SE_Block,
                      layers.ChannelAttention, layers.SpatialAttention,
                      layers.Classify)


def _fan_in(m: nn.Module) -> int:
    return (m.fan_in if isinstance(m, layers.DenseGeneral)
            else m.weight[0].numel())


def _lecun_normal(m: nn.Module, generator: Optional[torch.Generator]):
    """flax's lecun_normal: a normal of variance 1 / fan_in truncated at two
    standard deviations (rescaled so that the variance stays 1 / fan_in)."""
    w = m.kernel if isinstance(m, layers.DenseGeneral) else m.weight
    std = math.sqrt(1.0 / _fan_in(m)) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def build_model(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None) -> ICAFusionModel:
    """The model in float32. With ``generator``, every conv and linear layer
    (C3TR's attention projections too) is drawn anew from it, weights
    He-uniform (kaiming_uniform, a=0) so that
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
                elif isinstance(m, layers.DenseGeneral):   # C3TR's heads
                    bound = math.sqrt(6.0 / m.fan_in)
                    nn.init.uniform_(m.kernel, -bound, bound,
                                     generator=generator)
                else:
                    continue
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(_fan_in(m))
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)
    return model
