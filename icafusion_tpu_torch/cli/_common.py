"""What the port's CLIs share: model-config resolution and loading a model
for inference (the JAX package's cli/_common.py)."""

from __future__ import annotations

from pathlib import Path

import torch


def resolve_model_config(cfg: str, nc=None):
    """A model YAML (a path or a preset name), or a zoo spec as the JAX CLI
    takes it: 'zoo:<fusion>[:<scale>]' (e.g. zoo:nin:s; scale defaults to
    l), 'zoo:tiny[:<fusion>]', 'zoo:vgg16[:<fusion>]',
    'zoo:resnet50[:<fusion>]'. Fusions: tfb, nin, add, dmaf."""
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.models import zoo

    if not cfg.startswith("zoo:"):
        return load_model_config(cfg, nc=nc)
    parts = cfg.split(":")[1:]
    nc = nc or 3
    fusion = parts[1] if len(parts) > 1 else "tfb"
    if parts[0] == "tiny":
        return zoo.tiny_icafusion_config(nc=nc, fusion=fusion)
    if parts[0] == "vgg16":
        return zoo.vgg16_icafusion_config(nc=nc, fusion=fusion)
    if parts[0] == "resnet50":
        return zoo.resnet50_icafusion_config(nc=nc, fusion=fusion)
    return zoo.icafusion_config(parts[1] if len(parts) > 1 else "l", nc=nc,
                                fusion=parts[0])


def load_model_for_inference(cfg: str, weights: str, nc=None, merge=0):
    """(model config, float32 model holding the checkpoint's inference
    weights: EMA first). weights is a .ckpt of either package or a
    reference .pt (utils/torch_convert: every port tensor the .pt names is
    filled, the rest keep a seeded draw, as the JAX package keeps its
    init's); a missing .pt raises FileNotFoundError. merge=K (an int or a
    numeric string; "auto" is 0 in the port) stream-merges the first K
    RGB/IR layer pairs: the standard weights are loaded, then merged into
    the merged graph (utils/stream_merge.py)."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    from icafusion_tpu_torch.utils.stream_merge import (merged_model,
                                                        resolve_merge)

    mc = resolve_model_config(cfg, nc=nc)
    k = resolve_merge(merge, mc)
    if Path(weights).suffix == ".pt":
        from icafusion_tpu_torch.utils.torch_convert import (
            convert_state_dict, load_torch_checkpoint)
        if not Path(weights).is_file():
            raise FileNotFoundError(f"no reference checkpoint {weights}")
        model = build_model(mc, generator=torch.Generator().manual_seed(0))
        model, _ = convert_state_dict(load_torch_checkpoint(weights), model,
                                      strict=False)
    else:
        model = load_jax_variables(build_model(mc),
                                   load_inference_variables(weights))
    return mc, merged_model(model, k) if k else model


def mc_min_size(mc) -> int:
    """Smallest input size the config's fusion anchor grids allow: the
    TransformerFusionBlock rows come in P3/P4/P5 order (strides 8/16/32),
    and each level's grid must be at least its block's anchor grid."""
    grids = [int(l.args[1]) if len(l.args) > 1 else 16
             for l in mc.layers if l.module == "TransformerFusionBlock"]
    if not grids:
        return 64
    strides = (8, 16, 32, 64, 128)
    need = max(g * s for g, s in zip(grids, strides))
    return ((need + 31) // 32) * 32
