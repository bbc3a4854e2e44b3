"""Hub-style model factory of the port: the JAX package's hub.py
(reference hubconf.py:21-122).

    from icafusion_tpu_torch import hub
    model = hub.create("icafusion_s", nc=3)                    # random init
    model = hub.create("icafusion_l", weights="best.ckpt")
    engine = hub.pipeline("icafusion_s", weights="best.ckpt")  # ServingEngine

The names are the JAX hub's. The DMFF ("tfb") models at every scale and
icafusion_tiny build; the NiN and Add fusions (``*_nin``, ``*_add``) raise
ROADMAP A5, the VGG16 and ResNet50 backbones A10. ``create`` returns the
model holding its weights (the port keeps no separate variables).
"""

from __future__ import annotations

from typing import Optional

import torch

SCALES = "nsmlx"


def list_models():
    names = [f"icafusion_{s}{suffix}" for s in SCALES
             for suffix in ("", "_nin", "_add")]
    return sorted(names + ["icafusion_vgg16", "icafusion_resnet50",
                           "icafusion_tiny"])


def model_config(name: str, nc: int = 3):
    """The ModelConfig of a hub name; raises for a name not ported."""
    from icafusion_tpu_torch.models import zoo
    from icafusion_tpu_torch.utils.general import not_ported

    if name not in list_models():
        raise KeyError(f"unknown model {name!r}; see list_models()")
    kind = name[len("icafusion_"):]
    if kind == "tiny":
        return zoo.tiny_icafusion_config(nc=nc)
    if kind in ("vgg16", "resnet50"):
        not_ported(f"the {kind} backbone ({name})", "A10")
    if kind.endswith(("_nin", "_add")):
        not_ported(f"the {kind[2:]} fusion ({name})", "A5")
    return zoo.icafusion_config(kind, nc=nc)


def create(name: str, nc: int = 3, weights: Optional[str] = None,
           generator: Optional[torch.Generator] = None):
    """The float32 model of ``name`` (hubconf.create, hubconf.py:21-56):
    with ``weights`` (a .ckpt of either package) holding its inference
    weights, else drawn from ``generator`` (default: seed 0)."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables

    cfg = model_config(name, nc=nc)
    if weights:
        return load_jax_variables(build_model(cfg),
                                  load_inference_variables(weights))
    return build_model(cfg, generator=generator
                       or torch.Generator().manual_seed(0))


def pipeline(name: str, weights: Optional[str] = None, nc: int = 3,
             img_size=640, batch_size: int = 1, conf_thres: float = 0.25,
             merge_streams="auto", dtype: str = "bfloat16", device=None,
             generator: Optional[torch.Generator] = None):
    """A ready ServingEngine of ``name`` (the autoShape analog,
    common.py:400-553); merge_streams takes 0 or "auto" (ServingEngine)."""
    from icafusion_tpu_torch.serve.engine import ServingEngine
    model = create(name, nc=nc, weights=weights, generator=generator)
    return ServingEngine(model, img_size=img_size, batch_size=batch_size,
                         conf_thres=conf_thres, dtype=dtype, device=device,
                         merge_streams=merge_streams)
