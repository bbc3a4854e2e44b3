"""What the port's CLIs share: model-config resolution and loading a model
for inference (the JAX package's cli/_common.py)."""

from __future__ import annotations

from pathlib import Path

from icafusion_tpu_torch.utils.general import not_ported


def resolve_model_config(cfg: str, nc=None):
    """A model YAML (a path or a preset name), or a zoo spec:
    'zoo:<fusion>:<scale>' (e.g. zoo:tfb:l; scale defaults to l),
    'zoo:tiny[:<fusion>]'. Only the tfb fusion is ported (the NiN, Add and
    DMAF fusions are ROADMAP A5), and the zoo's VGG16 and ResNet50
    backbones are not (A10)."""
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.models import zoo

    if not cfg.startswith("zoo:"):
        return load_model_config(cfg, nc=nc)
    parts = cfg.split(":")[1:]
    if parts[0] in ("vgg16", "resnet50"):
        not_ported(f"the {parts[0]} backbone ({cfg})", "A10")
    if parts[0] == "tiny":
        fusion, scale = (parts[1] if len(parts) > 1 else "tfb"), None
    else:
        fusion, scale = parts[0], (parts[1] if len(parts) > 1 else "l")
    if fusion in ("nin", "add", "dmaf"):
        not_ported(f"the {fusion} fusion ({cfg})", "A5")
    if scale is None:
        return zoo.tiny_icafusion_config(nc=nc or 3, fusion=fusion)
    return zoo.icafusion_config(scale, nc=nc or 3, fusion=fusion)


def load_model_for_inference(cfg: str, weights: str, nc=None, merge=0):
    """(model config, float32 model holding the checkpoint's inference
    weights: EMA first). weights is a .ckpt of either package; a reference
    .pt and stream merging (merge other than 0) are not ported (A10)."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables

    if str(merge) not in ("0", ""):
        not_ported(f"--merge {merge} (stream merging)", "A10")
    if Path(weights).suffix == ".pt":
        not_ported("a reference .pt as weights", "A10")
    mc = resolve_model_config(cfg, nc=nc)
    model = load_jax_variables(build_model(mc),
                               load_inference_variables(weights))
    return mc, model


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
