"""Model-architecture config: YAML layer lists as frozen dataclasses.

A model YAML holds {nc, depth_multiple, width_multiple, anchors, backbone,
head}; each backbone/head row is [from, number, module, args] and the module
name is looked up in a registry (models/assembler.py) instead of being
eval()'d. ``from == -4`` is the dual-input sentinel: that layer takes the
second (IR) image.

PyYAML is imported only when a YAML file is read, so building a config from
code (models/zoo.py) needs nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional, Tuple, Union

FromSpec = Union[int, Tuple[int, ...]]

# module names of dead reference configs: no definition exists anywhere
KNOWN_UNDEFINED = {"GPT", "weightedAdd", "MobileViTBlock"}

# torch-flavoured YAML aliases -> registry names
NAME_ALIASES = {
    "nn.Upsample": "Upsample",
    "nn.BatchNorm2d": "BatchNorm2d",
    "nn.MaxPool2d": "MaxPool2d",
}

_MODELS_DIR = Path(__file__).resolve().parents[1] / "configs" / "models"


@dataclasses.dataclass(frozen=True)
class LayerDef:
    """One row of the backbone/head list: [from, number, module, args]."""
    i: int                 # layer index in the flattened backbone+head list
    f: FromSpec            # input source(s); -1 previous, -4 the IR input
    n: int                 # repeat count (before depth_multiple)
    module: str            # registry name
    args: Tuple[Any, ...]  # YAML args with nc/anchors/None/True/False resolved


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    nc: int
    depth_multiple: float
    width_multiple: float
    anchors: Tuple[Tuple[float, ...], ...]   # (nl, na*2) pixel anchors
    layers: Tuple[LayerDef, ...]             # backbone + head, flattened
    ch: int = 3                              # input channels per stream
    name: str = "model"

    @property
    def no(self) -> int:
        """Detect's output channels per level, na * (nc + 5)."""
        return len(self.anchors[0]) // 2 * (self.nc + 5)


def _norm_from(f) -> FromSpec:
    if isinstance(f, list):
        return tuple(int(x) for x in f)
    return int(f)


def _norm_module_name(m) -> str:
    m = str(m)
    if m in KNOWN_UNDEFINED:
        raise ValueError(f"Module '{m}' has no definition (dead config); "
                         "refusing to build.")
    return NAME_ALIASES.get(m, m)


def _norm_arg(a, nc, anchors):
    if isinstance(a, str):
        return {"nc": nc, "anchors": anchors, "None": None, "True": True,
                "False": False}.get(a, a)
    if isinstance(a, list):
        return tuple(_norm_arg(x, nc, anchors) for x in a)
    return a


def _read_yaml(spec) -> Tuple[dict, str]:
    path = Path(spec)
    if not path.exists():
        path = _MODELS_DIR / path.name
    if not path.exists():
        raise FileNotFoundError(f"model config '{spec}' not found (as a path "
                                f"or under {_MODELS_DIR})")
    import yaml
    with open(path) as f:
        return yaml.safe_load(f), Path(spec).stem


def load_model_config(path_or_dict, nc: Optional[int] = None,
                      anchors=None, ch: int = 3) -> ModelConfig:
    """Parse a model YAML (a path, a file name under configs/models, or the
    already-loaded dict) into a ModelConfig, with optional nc/anchors
    overrides."""
    if isinstance(path_or_dict, (str, Path)):
        d, name = _read_yaml(path_or_dict)
    else:
        d = dict(path_or_dict)
        name = d.get("name", "model")

    cfg_nc = int(d["nc"]) if nc is None else int(nc)
    cfg_anchors = d["anchors"] if anchors is None else anchors
    if isinstance(cfg_anchors, int):
        # 'anchors: N' = N auto-anchors per level, placeholder wh pairs
        cfg_anchors = [list(range(2 * cfg_anchors))] * 3
    anchors_t = tuple(tuple(float(x) for x in row) for row in cfg_anchors)

    rows = list(d["backbone"]) + list(d["head"])
    layers = tuple(
        LayerDef(i=i, f=_norm_from(f), n=int(n), module=_norm_module_name(m),
                 args=tuple(_norm_arg(a, cfg_nc, anchors_t) for a in args))
        for i, (f, n, m, args) in enumerate(rows))
    return ModelConfig(nc=cfg_nc, depth_multiple=float(d["depth_multiple"]),
                       width_multiple=float(d["width_multiple"]),
                       anchors=anchors_t, layers=layers,
                       ch=int(d.get("ch", ch)), name=name)
