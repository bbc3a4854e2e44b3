"""Model zoo: the ICAFusion detector families, as code.

The same layer graphs as the JAX package's models/zoo.py builds:
``icafusion_config("l", nc=3)`` is the graph of
configs/models/yolov5l_Transfusion.yaml (two CSPDarknet towers, the second
fed by the ``-4`` IR sentinel; TransformerFusionBlocks at P3/P4/P5; the
PANet head and Detect). ``fusion`` picks the block at each level: "tfb"
(DMFF), "nin" (NiNfusion), "add" (Add) or "dmaf" (DMAF, Add2 and Add);
``vgg16_icafusion_config`` and ``resnet50_icafusion_config`` swap the
towers for VGG16 or ResNet50 ones.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def _panet_head(p3: int, p4: int, p5: int, widths=(512, 256),
                p5_out: int = None) -> List[list]:
    """PANet top-down + bottom-up neck and Detect over the fusion outputs
    p3/p4/p5 (yolov5l_Transfusion_FLIR.yaml:47-65). p5_out: the channels of
    the last C3, 2 * widths[0] but for VGG16's head, which caps it at 512."""
    w1, w2 = widths
    p5_out = 2 * w1 if p5_out is None else p5_out
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
        [-1, 3, "C3", [p5_out, "False"]],                   # base+13 P5 out
        [[base + 7, base + 10, base + 13], 1, "Detect", ["nc", "anchors"]],
    ]


def _fusion_stride(kind: str) -> int:
    """Rows a fusion site takes (dmaf's block has four)."""
    return 4 if kind == "dmaf" else 1


def _fusion_rows(kind: str, pairs: Sequence[Tuple[int, int]],
                 dims: Sequence[int]) -> List[list]:
    """The fusion rows at P3/P4/P5 of the tower outputs ``pairs``."""
    rows = []
    for (a, b), d, (vh, hz) in zip(pairs, dims, TFB_GRIDS):
        if kind == "tfb":
            rows.append([[a, b], 1, "TransformerFusionBlock", [d, vh, hz]])
        elif kind == "nin":
            rows.append([[a, b], 1, "NiNfusion", [1, 1]])
        elif kind == "add":
            rows.append([[a, b], 1, "Add", [1]])
        elif kind == "dmaf":
            # each stream plus its cross-gated difference map, then the
            # blend of the two for the head (common.py:363-383)
            rows += [
                [[a, b], 1, "DMAF", [d]],
                [[a, -1], 1, "Add2", [d, 0]],
                [[b, -2], 1, "Add2", [d, 1]],
                [[-2, -1], 1, "Add", [d]],
            ]
        else:
            raise ValueError(f"unknown fusion kind {kind!r}")
    return rows


def _two_stream(towers: List[list], fusion: str, fusion_rows: List[list],
                nc: int, gd: float, gw: float, anchors, name: str,
                **head) -> ModelConfig:
    """Both towers' rows, the fusion rows, and the PANet head over the
    fusion outputs."""
    base, k = len(towers), _fusion_stride(fusion)
    rows = towers + fusion_rows
    rows += _panet_head(p3=base + k - 1, p4=base + 2 * k - 1,
                        p5=base + 3 * k - 1, **head)
    d = dict(nc=nc, depth_multiple=gd, width_multiple=gw,
             anchors=list(anchors), backbone=rows[:base + 3 * k],
             head=rows[base + 3 * k:], name=name)
    return load_model_config(d, nc=nc)


def icafusion_config(scale: str = "l", nc: int = 3, fusion: str = "tfb",
                     anchors=COCO_ANCHORS, name: str = "") -> ModelConfig:
    """Two-stream CSPDarknet + fusion + PANet at yolov5 scale n/s/m/l/x
    (depth and width multiples of SCALES): the graphs of
    yolov5{scale}_{Transfusion,NiNfusion,Add}.yaml."""
    gd, gw = SCALES[scale]
    fused = _fusion_rows(fusion, ((4, 14), (6, 16), (9, 19)), (256, 512, 1024))
    return _two_stream(_csp_tower(-1) + _csp_tower(-4), fusion, fused, nc,
                       gd, gw, anchors, name or f"icafusion_{fusion}_{scale}")


def tiny_icafusion_config(nc: int = 3, fusion: str = "tfb") -> ModelConfig:
    """Micro two-stream model of the same family for tests (about 0.2 M
    parameters, any image size from 64 px; TFB grids 4x4, 4x4, 2x2). Not a
    reference architecture."""
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
    if fusion == "tfb":     # grids the size of a 64 px input's maps
        fused = [[[4, 13], 1, "TransformerFusionBlock", [48, 4, 4]],
                 [[6, 15], 1, "TransformerFusionBlock", [64, 4, 4]],
                 [[8, 17], 1, "TransformerFusionBlock", [96, 2, 2]]]
    else:
        fused = _fusion_rows(fusion, ((4, 13), (6, 15), (8, 17)), (48, 64, 96))
    return _two_stream(tower(-1) + tower(-4), fusion, fused, nc, 1.0, 1.0,
                       COCO_ANCHORS, f"icafusion_tiny_{fusion}",
                       widths=(64, 48))


def vgg16_icafusion_config(nc: int = 3, fusion: str = "tfb",
                           anchors=COCO_ANCHORS) -> ModelConfig:
    """Two-stream VGG16 towers + fusion + PANet: the graphs of
    yolov5_VGG16_{Transfusion,NiNfusion,Add}.yaml."""
    tower = lambda f: [
        [f, 1, "VGGblock", [2, 3, 64]],
        [-1, 1, "VGGblock", [2, 64, 128]],
        [-1, 1, "VGGblock", [3, 128, 256]],      # P3/8
        [-1, 1, "VGGblock", [3, 256, 512]],      # P4/16
        [-1, 1, "VGGblock", [3, 512, 512]],      # P5/32
    ]
    fused = _fusion_rows(fusion, ((2, 7), (3, 8), (4, 9)), (256, 512, 512))
    return _two_stream(tower(-1) + tower(-4), fusion, fused, nc, 1.0, 1.0,
                       anchors, f"icafusion_vgg16_{fusion}", p5_out=512)


def resnet50_icafusion_config(nc: int = 3, fusion: str = "tfb",
                              anchors=COCO_ANCHORS) -> ModelConfig:
    """Two-stream ResNet50 towers + fusion + PANet: the graphs of
    yolov5_ResNet50_{Transfusion,NiNfusion,Add}.yaml."""
    tower = lambda f: [
        [f, 1, "ResNetlayer", [3, 64, 1, "True", 1]],
        [-1, 1, "ResNetlayer", [64, 64, 1, "False", 3]],
        [-1, 1, "ResNetlayer", [256, 128, 2, "False", 4]],    # P3/8
        [-1, 1, "ResNetlayer", [512, 256, 2, "False", 6]],    # P4/16
        [-1, 1, "ResNetlayer", [1024, 512, 2, "False", 3]],   # P5/32
    ]
    fused = _fusion_rows(fusion, ((2, 7), (3, 8), (4, 9)), (512, 1024, 2048))
    return _two_stream(tower(-1) + tower(-4), fusion, fused, nc, 1.0, 1.0,
                       anchors, f"icafusion_resnet50_{fusion}",
                       widths=(1024, 512))
