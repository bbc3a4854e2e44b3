"""Model zoo: the ICAFusion detector with DMFF fusion, as code.

The same layer graphs as the JAX package's models/zoo.py builds for
fusion="tfb": ``icafusion_config("l", nc=3)`` is the graph of
configs/models/yolov5l_Transfusion.yaml (two CSPDarknet towers, the second
fed by the ``-4`` IR sentinel; TransformerFusionBlocks at P3/P4/P5; the
PANet head and Detect). The other fusion families are not ported yet.
"""

from __future__ import annotations

from typing import List

from icafusion_tpu_torch.config import ModelConfig, load_model_config

SCALES = {          # (depth_multiple, width_multiple)
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

COCO_ANCHORS = ((10, 13, 16, 30, 33, 23),
                (30, 61, 62, 45, 59, 119),
                (116, 90, 156, 198, 373, 326))

# DMFF anchor grids per level (yolov5l_Transfusion_FLIR.yaml:39-41)
TFB_GRIDS = ((20, 20), (16, 16), (10, 10))


def _csp_tower(first_from: int) -> List[list]:
    """One CSPDarknet-v5 tower, P1 to SPPF (yolov5l_Transfusion_FLIR.yaml:16-25)."""
    return [
        [first_from, 1, "Conv", [64, 6, 2, 2]],     # P1/2
        [-1, 1, "Conv", [128, 3, 2]],                # P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],                # P3/8
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],                # P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],               # P5/32
        [-1, 3, "C3", [1024]],
        [-1, 1, "SPPF", [1024, 5]],
    ]


def _panet_head(p3: int, p4: int, p5: int, widths=(512, 256)) -> List[list]:
    """PANet top-down + bottom-up neck and Detect over the fusion outputs
    p3/p4/p5 (yolov5l_Transfusion_FLIR.yaml:47-65)."""
    w1, w2 = widths
    base = p5 + 1
    return [
        [-1, 1, "Conv", [w1, 1, 1]],                        # base+0
        [-1, 1, "Upsample", ["None", 2, "nearest"]],
        [[-1, p4], 1, "Concat", [1]],
        [-1, 3, "C3", [w1, "False"]],
        [-1, 1, "Conv", [w2, 1, 1]],                        # base+4
        [-1, 1, "Upsample", ["None", 2, "nearest"]],
        [[-1, p3], 1, "Concat", [1]],
        [-1, 3, "C3", [w2, "False"]],                       # base+7  P3 out
        [-1, 1, "Conv", [w2, 3, 2]],
        [[-1, base + 4], 1, "Concat", [1]],
        [-1, 3, "C3", [w1, "False"]],                       # base+10 P4 out
        [-1, 1, "Conv", [w1, 3, 2]],
        [[-1, base + 0], 1, "Concat", [1]],
        [-1, 3, "C3", [2 * w1, "False"]],                   # base+13 P5 out
        [[base + 7, base + 10, base + 13], 1, "Detect", ["nc", "anchors"]],
    ]


def _check_fusion(fusion: str):
    if fusion != "tfb":
        raise ValueError(f"fusion {fusion!r} is not ported (only 'tfb')")


def icafusion_config(scale: str = "l", nc: int = 3, fusion: str = "tfb",
                     anchors=COCO_ANCHORS, name: str = "") -> ModelConfig:
    """Two-stream CSPDarknet + DMFF fusion + PANet at yolov5 scale
    n/s/m/l/x (depth and width multiples of SCALES)."""
    _check_fusion(fusion)
    gd, gw = SCALES[scale]
    rows = _csp_tower(-1) + _csp_tower(-4)
    rows += [[[a, b], 1, "TransformerFusionBlock", [d, vh, hz]]
             for (a, b), d, (vh, hz) in zip(((4, 14), (6, 16), (9, 19)),
                                            (256, 512, 1024), TFB_GRIDS)]
    rows += _panet_head(p3=20, p4=21, p5=22)
    d = dict(nc=nc, depth_multiple=gd, width_multiple=gw, anchors=list(anchors),
             backbone=rows[:23], head=rows[23:],
             name=name or f"icafusion_{fusion}_{scale}")
    return load_model_config(d, nc=nc)


def tiny_icafusion_config(nc: int = 3, fusion: str = "tfb") -> ModelConfig:
    """Micro two-stream model of the same family for tests (about 0.2 M
    parameters, any image size from 64 px; TFB grids 4x4, 4x4, 2x2). Not a
    reference architecture."""
    _check_fusion(fusion)
    tower = lambda f: [
        [f, 1, "Conv", [16, 6, 2, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "C3", [32]],
        [-1, 1, "Conv", [48, 3, 2]],     # P3/8
        [-1, 1, "C3", [48]],
        [-1, 1, "Conv", [64, 3, 2]],     # P4/16
        [-1, 1, "C3", [64]],
        [-1, 1, "Conv", [96, 3, 2]],     # P5/32
        [-1, 1, "SPPF", [96, 5]],
    ]
    rows = tower(-1) + tower(-4) + [
        [[4, 13], 1, "TransformerFusionBlock", [48, 4, 4]],
        [[6, 15], 1, "TransformerFusionBlock", [64, 4, 4]],
        [[8, 17], 1, "TransformerFusionBlock", [96, 2, 2]],
    ]
    rows += _panet_head(p3=18, p4=19, p5=20, widths=(64, 48))
    d = dict(nc=nc, depth_multiple=1.0, width_multiple=1.0,
             anchors=list(COCO_ANCHORS), backbone=rows[:21], head=rows[21:],
             name=f"icafusion_tiny_{fusion}")
    return load_model_config(d, nc=nc)
