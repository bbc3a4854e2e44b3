"""Hub-style model factory of the port: the JAX package's hub.py
(reference hubconf.py:21-122).

    from icafusion_tpu_torch import hub
    model = hub.create("icafusion_s", nc=3)                    # random init
    model = hub.create("icafusion_l", weights="best.ckpt")
    engine = hub.pipeline("icafusion_s", weights="best.ckpt")  # ServingEngine

The names and their configs are the JAX hub's: ``icafusion_{n,s,m,l,x}``
(DMFF), ``icafusion_{scale}_nin`` and ``icafusion_{scale}_add``,
``icafusion_vgg16`` and ``icafusion_resnet50`` (DMFF) and ``icafusion_tiny``.
``create`` returns the model holding its weights (the port keeps no
separate variables).
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
    """The ModelConfig of a hub name (the JAX hub's factories)."""
    from icafusion_tpu_torch.models import zoo

    if name not in list_models():
        raise KeyError(f"unknown model {name!r}; see list_models()")
    kind = name[len("icafusion_"):]
    if kind == "tiny":
        return zoo.tiny_icafusion_config(nc=nc)
    if kind == "vgg16":
        return zoo.vgg16_icafusion_config(nc=nc)
    if kind == "resnet50":
        return zoo.resnet50_icafusion_config(nc=nc)
    scale, _, fusion = kind.partition("_")
    return zoo.icafusion_config(scale, nc=nc, fusion=fusion or "tfb")


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
    common.py:400-553). merge_streams: K stream-merges the first K RGB/IR
    layer pairs (utils/stream_merge.py; the same outputs); "auto" is 0 in
    the port (ServingEngine)."""
    from icafusion_tpu_torch.serve.engine import ServingEngine
    model = create(name, nc=nc, weights=weights, generator=generator)
    return ServingEngine(model, img_size=img_size, batch_size=batch_size,
                         conf_thres=conf_thres, dtype=dtype, device=device,
                         merge_streams=merge_streams)
