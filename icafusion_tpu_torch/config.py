"""The three config tiers as frozen dataclasses: model, dataset and
hyperparameters (the JAX package's config.py).

A model YAML holds {nc, depth_multiple, width_multiple, anchors, backbone,
head}; each backbone/head row is [from, number, module, args] and the module
name is looked up in a registry (models/assembler.py) instead of being
eval()'d. ``from == -4`` is the dual-input sentinel: that layer takes the
second (IR) image. A data YAML names the paired RGB/IR image lists, nc and
the class names; a hyp YAML holds the 29 learning-rate, loss and
augmentation keys of the reference's hyp.scratch.yaml.

Bare names resolve against the presets under configs/{models,data,hyp}, as
the JAX package resolves them. PyYAML is imported only when a YAML file is
read, so building a config from code (models/zoo.py) needs nothing beyond
the standard library.
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

_CONFIGS_ROOT = Path(__file__).resolve().parents[1] / "configs"
_MODELS_DIR = _CONFIGS_ROOT / "models"


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
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def no(self) -> int:
        """Detect's output channels per level, na * (nc + 5)."""
        return self.na * (self.nc + 5)


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


def _load_yaml(path) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


# nc of the reference's per-dataset model files (<base>_<DATASET>.yaml,
# which differ from <base>.yaml only in nc)
_MODEL_DATASET_NC = {"FLIR": 3, "kaist": 1, "VEDAI": 9, "LLVIP": 1,
                     "SeaDrone": 7, "CVC14": 1}


def _norm_stem(name: str) -> str:
    return Path(name).stem.lower().replace("-", "_")


def resolve_model_yaml(spec) -> Tuple[Path, Optional[int]]:
    """(yaml path, nc override) of a model spec: an existing path, a preset
    name under configs/models, or a reference-style per-dataset name
    (yolov5n_Transfusion_FLIR.yaml -> the preset with the dataset's nc)."""
    p = Path(spec)
    if p.exists():
        return p, None
    cand = _MODELS_DIR / p.name
    if cand.exists():
        return cand, None
    for suffix, nc in _MODEL_DATASET_NC.items():
        if p.stem.lower().endswith("_" + suffix.lower()):
            cand = _MODELS_DIR / (p.stem[: -(len(suffix) + 1)] + ".yaml")
            if cand.exists():
                return cand, nc
    want = _norm_stem(spec)
    for f in sorted(_CONFIGS_ROOT.rglob("*.yaml")):
        if _norm_stem(f.name) == want:
            return f, None
    raise FileNotFoundError(f"model config '{spec}' not found (as a path, "
                            f"under {_MODELS_DIR}, or as <base>_<DATASET>"
                            ".yaml)")


def resolve_data_yaml(spec) -> Path:
    """An existing path, a preset under configs/data, or a reference data
    YAML name matched by its case- and hyphen-insensitive stem."""
    p = Path(spec)
    if p.exists():
        return p
    data_dir = _CONFIGS_ROOT / "data"
    if (data_dir / p.name).exists():
        return data_dir / p.name
    want = _norm_stem(spec)
    for f in sorted(data_dir.glob("*.yaml")):
        if _norm_stem(f.name) == want:
            return f
    raise FileNotFoundError(f"data config '{spec}' not found (as a path or "
                            f"under {data_dir})")


def resolve_hyp_yaml(spec) -> Path:
    p = Path(spec)
    if p.exists():
        return p
    cand = _CONFIGS_ROOT / "hyp" / p.name
    if cand.exists():
        return cand
    raise FileNotFoundError(f"hyp config '{spec}' not found (as a path or "
                            f"under {_CONFIGS_ROOT / 'hyp'})")


def load_model_config(path_or_dict, nc: Optional[int] = None,
                      anchors=None, ch: int = 3) -> ModelConfig:
    """Parse a model YAML (a path, a file name under configs/models, or the
    already-loaded dict) into a ModelConfig, with optional nc/anchors
    overrides."""
    if isinstance(path_or_dict, (str, Path)):
        path, suffix_nc = resolve_model_yaml(path_or_dict)
        nc = suffix_nc if nc is None else nc
        d, name = _load_yaml(path), Path(path_or_dict).stem
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


def with_anchors(cfg: ModelConfig, anchors) -> ModelConfig:
    """The config with its anchors (and Detect's) replaced, e.g. by
    autoanchor's result."""
    flat = [float(x) for x in _flatten(anchors)]
    per = len(flat) // cfg.nl
    anchors_t = tuple(tuple(flat[i * per:(i + 1) * per])
                      for i in range(cfg.nl))
    layers = tuple(
        dataclasses.replace(l, args=(l.args[0], anchors_t) + tuple(l.args[2:]))
        if l.module == "Detect" else l for l in cfg.layers)
    return dataclasses.replace(cfg, anchors=anchors_t, layers=layers)


def _flatten(x):
    if hasattr(x, "tolist"):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _flatten(v)
    else:
        yield x


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Paired multispectral dataset description (configs/data/*.yaml)."""
    nc: int
    names: Tuple[str, ...]
    path: str = ""
    train_rgb: str = ""
    val_rgb: str = ""
    test_rgb: str = ""
    train_ir: str = ""
    val_ir: str = ""
    test_ir: str = ""


def load_data_config(path) -> DataConfig:
    d = _load_yaml(resolve_data_yaml(path))
    names = d.get("names", [])
    nc = int(d.get("nc", len(names)))
    if names and len(names) != nc:
        raise ValueError(f"data config {path}: len(names)={len(names)} != "
                         f"nc={nc}")
    return DataConfig(
        nc=nc, names=tuple(str(n) for n in names),
        path=str(d.get("path", "")),
        train_rgb=str(d.get("train_rgb", d.get("train", ""))),
        val_rgb=str(d.get("val_rgb", d.get("val", ""))),
        test_rgb=str(d.get("test_rgb", d.get("test", ""))),
        train_ir=str(d.get("train_ir", "")),
        val_ir=str(d.get("val_ir", "")),
        test_ir=str(d.get("test_ir", "")))


@dataclasses.dataclass(frozen=True)
class HypConfig:
    """The hyperparameters with the reference's defaults
    (data/hyp.scratch.yaml)."""
    lr0: float = 0.01
    lrf: float = 0.1
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    box: float = 0.05
    cls: float = 0.5
    cls_pw: float = 1.0
    obj: float = 1.0
    obj_pw: float = 1.0
    iou_t: float = 0.20
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mixup: float = 0.0
    anchors: float = 0.0

    def replace(self, **kw) -> "HypConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_hyp_config(path=None, **overrides) -> HypConfig:
    """The defaults, updated from a hyp YAML (unknown keys are reported and
    ignored) and then from ``overrides``."""
    d = HypConfig().as_dict()
    if path is not None:
        loaded = _load_yaml(resolve_hyp_yaml(path))
        unknown = set(loaded) - set(d)
        if unknown:
            print(f"hyp config {path}: ignoring unknown keys "
                  f"{sorted(unknown)}")
        d.update({k: v for k, v in loaded.items() if k in d})
    d.update(overrides)
    return HypConfig(**d)
