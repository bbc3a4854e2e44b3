"""The 64-channel conv's memory layouts on the CPU (``kernels/packed_conv.py``,
``csrc/conv3x3_bn_silu.cu``).

Each dtype's kernel takes one of three routes: channels_last maps by TMA
("nhwc"), NCHW maps by TMA over a channel-major box where a row is a
multiple of 16 bytes ("nchw_tma"), else by the threads' own loads
("nchw_ld"). Here: the route of every shape chip_smoke.py's phase 3b runs;
a numpy emulation of the NCHW halo (the TMA box from its 16-byte aligned
start with the zero fill, bf16's transposition into the nhwc route's
swizzled pixel-major halo, fp32's scalar A reads from the box) against
``F.pad`` windows, with the box geometry read from the CUDA source; fp32's
k order (weight_k, read from the source) against its A fragments, and
bf16's NCHW stores; and the
layout each fused conv receives along the entry points, recorded on the CPU
path: the engine, the Evaluator and fit give channels_last, a ``.pt2``
program, Grad-CAM, ``ensemble_predict`` and a ``hub.create`` model called
on an ordinary tensor give NCHW. The kernels themselves run only on the
card (tests/test_torch_port_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import packed_conv
from icafusion_tpu_torch.smoke.common import CONV_SHAPES

torch.set_num_threads(1)

CSRC = (Path(packed_conv.__file__).resolve().parents[1] / "csrc"
        / "conv3x3_bn_silu.cu").read_text()


def cu_constants(namespace: str) -> dict:
    """The ``constexpr int`` constants of a namespace of the CUDA source."""
    body = CSRC[CSRC.index(f"namespace {namespace} {{"):
                CSRC.index(f"}}  // namespace {namespace}")]
    out = {"kC": 64, "kTaps": 9}     # the source's file-level constants
    for decl in re.findall(r"^\s*constexpr int (k[^;(]*);", body, re.M):
        for name, expr in re.findall(r"(k\w+) = ([^,]+)", decl):
            out[name] = eval(expr.replace("/", "//"), {}, dict(out))
    return out


BF16 = cu_constants("bf16")
TF32 = cu_constants("tf32")


# ---- (a) the route of every phase 3b shape -----------------------------------

# the NCHW widths of CONV_SHAPES whose rows are no multiple of 16 bytes
LD_WIDTHS = {torch.bfloat16: {20, 13, 5, 33, 84}, torch.float32: {13, 5, 33}}


@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format],
                         ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_at_every_phase_3b_shape(dtype, layout):
    """channels_last -> nhwc; NCHW -> nchw_tma where W % 8 (bf16) or W % 4
    (fp32) is 0, else nchw_ld; (1, 64, 1, 1) is dense in both layouts and
    takes nhwc. The C entry's route_of applies the same rule."""
    per16 = 16 // (torch.finfo(dtype).bits // 8)   # elements in 16 bytes
    assert "W % (is_bf16 ? 8 : 4) == 0 ? kNchwTma : kNchwLd" in CSRC
    ld = set()
    for shape in CONV_SHAPES:
        x = torch.empty(shape, dtype=dtype, device="meta").contiguous(
            memory_format=layout)
        got = packed_conv.route(x)
        W = shape[3]
        if layout == torch.channels_last or shape[2:] == (1, 1):
            assert got == "nhwc", shape
        else:
            assert got == ("nchw_tma" if W % per16 == 0 else "nchw_ld"), shape
            if got == "nchw_ld":
                ld.add(W)
    assert ld == (set() if layout == torch.channels_last
                  else LD_WIDTHS[dtype])
    assert packed_conv.ROUTES.index("nhwc") == 0
    assert re.search(r"kNhwc = 0, kNchwTma = 1, kNchwLd = 2", CSRC)


# ---- (b) the NCHW halo, emulated ----------------------------------------------

def tma_box(x: np.ndarray, b: int, c0: int, h0: int, w0: int, boxc: int,
            boxh: int, boxw: int) -> np.ndarray:
    """A TMA tile load of x (B, C, H, W) in NCHW: the box (boxc, boxh, boxw)
    from (b, c0, h0, w0), zero where it leaves x (negative starts too)."""
    out = np.zeros((boxc, boxh, boxw), x.dtype)
    B, C, H, W = x.shape
    hs, ws = max(h0, 0), max(w0, 0)
    he, we = min(h0 + boxh, H), min(w0 + boxw, W)
    if he > hs and we > ws:
        out[:, hs - h0:he - h0, ws - w0:we - w0] = x[b, c0:c0 + boxc, hs:he,
                                                     ws:we]
    return out


def halo_bf16(value) -> np.ndarray:
    """fill_halo: unit u (pixel p = u % 108, chunk c = u // 108) writes
    channels 8c .. 8c + 7 of halo pixel p (row p // 18, column p % 18) as
    one 16-byte chunk at byte p * 128 + ((c ^ (p & 7)) << 4). Returns the
    halo as 2-byte elements."""
    hh, hw = BF16["kHH"], BF16["kHW"]
    halo = np.full(BF16["kHaloSlot"] // 2, np.nan, np.float32)
    for u in range(hh * hw * 8):
        p, c = u % (hh * hw), u // (hh * hw)
        at = (p * 128 + ((c ^ (p & 7)) << 4)) // 2
        halo[at:at + 8] = [value(8 * c + e, p // hw, p % hw)
                           for e in range(8)]
    return halo


def ldmatrix_read(halo: np.ndarray, p: int) -> np.ndarray:
    """The 64 channels of halo pixel p as load_a addresses them: chunk q of
    row p at p * 128 + ((q ^ (p & 7)) << 4)."""
    return np.concatenate([halo[(p * 128 + ((q ^ (p & 7)) << 4)) // 2:][:8]
                           for q in range(8)])


def tiles(H: int, W: int, th: int, tw: int):
    return [(h0, w0) for h0 in range(0, H, th) for w0 in range(0, W, tw)]


RAGGED = [(2, 64, 10, 13), (1, 64, 7, 5), (1, 64, 20, 20), (2, 64, 17, 24)]


@pytest.mark.parametrize("shape", RAGGED)
def test_bf16_nchw_halo_matches_padded_windows(shape):
    """nchw_tma: the box starts 16 bytes left of the tile (w0 - 8, so the
    halo's column c is box column c + 7) and spans kBoxW columns; it is
    transposed into the swizzled pixel-major halo; ldmatrix's addresses
    read back each halo pixel's 64 channels equal to the zero-padded x's
    window at (h0 - 1, w0 - 1). nchw_ld fills the same halo from x with its
    own masked loads."""
    th, tw = BF16["kTH"], BF16["kTW"]
    hh, hw, bw, col0 = BF16["kHH"], BF16["kHW"], BF16["kBoxW"], BF16["kBoxCol0"]
    assert bw % 8 == 0 and col0 + hw <= bw and (1 + col0) * 2 % 16 == 0
    rng = np.random.default_rng(shape[3])
    x = rng.standard_normal(shape).astype(np.float32)
    B, C, H, W = shape
    # zero pad 1 and the ragged tiles' overhang
    xp = F.pad(torch.from_numpy(x), (1, tw + 1, 1, th + 1)).numpy()
    for b in range(B):
        for h0, w0 in tiles(H, W, th, tw):
            start = w0 - 1 - col0
            assert start * 2 % 16 == 0     # TMA traps on another start
            box = tma_box(x, b, 0, h0 - 1, start, C, hh, bw)
            by_tma = halo_bf16(lambda c, r, col: box[c, r, col0 + col])

            def masked(c, r, col):
                h, w = h0 - 1 + r, w0 - 1 + col
                return x[b, c, h, w] if 0 <= h < H and 0 <= w < W else 0.0
            by_ld = halo_bf16(masked)
            want = xp[b, :, h0:h0 + hh, w0:w0 + hw]
            for p in range(hh * hw):
                for halo in (by_tma, by_ld):
                    np.testing.assert_array_equal(
                        ldmatrix_read(halo, p), want[:, p // hw, p % hw])


def frag_col(g: int) -> int:
    """conv3x3_bn_silu.cu: frag_col."""
    return (g >> 1) + 4 * (g & 1)


@pytest.mark.parametrize("shape", RAGGED)
def test_fp32_nchw_box_reads_match_padded_windows(shape):
    """nchw_tma and nchw_ld: the box of half hh (32 channels, kHH rows,
    kBoxW columns from w0 - 4, so halo column c is box column c + 3);
    load_unit's scalar reads (lane qg, qt: channels qt + 4i of the unit's
    16, pixel frag_col(qg) + 8 hf of the warp's row, shifted by the tap)
    equal the zero-padded x's window, and the 32 lanes of each read hit 32
    distinct banks."""
    th, tw = TF32["kTH"], TF32["kTW"]
    hh, bw, col0 = TF32["kHH"], TF32["kBoxW"], TF32["kBoxCol0"]
    assert bw % 4 == 0 and col0 + TF32["kHW"] <= bw
    rng = np.random.default_rng(shape[3])
    x = rng.standard_normal(shape).astype(np.float32)
    B, C, H, W = shape
    xp = F.pad(torch.from_numpy(x), (1, tw + 1, 1, th + 1)).numpy()
    qg, qt = np.divmod(np.arange(32), 4)
    col = np.array([frag_col(g) for g in qg])
    for b in range(B):
        for h0, w0 in tiles(H, W, th, tw):
            start = w0 - 1 - col0
            assert start * 4 % 16 == 0
            for half in range(2):
                box = tma_box(x, b, 32 * half, h0 - 1, start, 32, hh, bw)
                flat = box.reshape(-1)
                for u in range(18):              # a half's 18 units
                    tap, grp = u >> 1, u & 1
                    kh, kw = divmod(tap, 3)
                    for row in range(th):
                        for hf in range(2):
                            for i in range(4):
                                ch = 16 * grp + qt + 4 * i
                                px = col0 + col + 8 * hf + kw
                                word = (ch * hh + row + kh) * bw + px
                                assert len(set(word % 32)) == 32
                                np.testing.assert_array_equal(
                                    flat[word], xp[b, 32 * half + ch,
                                                   h0 + row + kh,
                                                   w0 + col + 8 * hf + kw])


def weight_k(route: str):
    """conv3x3_bn_silu.cu's weight_k<R>, read from the source: the k
    position (8 x k8 step + k) at which stage_weights_tf32 puts the weights
    of channel ci of a 32-channel half."""
    body = CSRC[CSRC.index("int weight_k(int ci_in_half) {"):]
    body = body[:body.index("\n}")]
    nchw = re.search(r"if constexpr \(R != kNhwc\) return ([^;]+);", body)
    grp, r = re.search(r"const int grp = ([^,]+), r = ([^;]+);", body).groups()
    nhwc = body.rsplit("return ", 1)[1].rstrip(";\n ")

    def k(ci_in_half):
        env = {"ci_in_half": ci_in_half}
        if route == "nchw":
            return eval(nchw.group(1), {}, env)
        env.update(grp=eval(grp, {}, env), r=eval(r, {}, env))
        return eval(nhwc, {}, env)
    return k


@pytest.mark.parametrize("route", ["nhwc", "nchw"])
def test_fp32_a_fragments_meet_their_weights(route):
    """The k order of fp32's products, both layouts. load_unit gives lane
    (qg, qt) the 4 channels of its pixel as v.x .. v.w (nhwc 4qt .. 4qt +
    3 of the unit's 16, one 16-byte chunk; nchw qt, qt + 4, qt + 8, qt +
    12, four scalars) and feeds k8 step st of the unit v.(2st) at the A
    fragment's column qt and v.(2st + 1) at column qt + 4 (wgmma's tf32
    A layout: a0 row qg col qt, a1 row qg + 8, a2 col qt + 4, a3 both).
    The weight at that k position (weight_k, read from the source) must
    be the same channel's: the emulated products of a half equal the dot
    product of each pixel's 32 channels with their weights."""
    wk = weight_k(route)
    where = [wk(ci) for ci in range(32)]
    assert sorted(where) == list(range(32)), where     # a permutation
    channel_at = np.argsort(where)                      # k -> channel
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 32))                   # pixel, channel
    w = rng.standard_normal(32)
    got = np.zeros(16)
    for unit in range(2):                               # 16 channels each
        for st in range(2):
            kk = 2 * unit + st                          # k8 step of the half
            for lane in range(32):
                qg, qt = divmod(lane, 4)
                for j in range(2):                      # column qt + 4j
                    e = 2 * st + j                      # v.x, .y, .z, .w
                    ch = 16 * unit + (4 * qt + e if route == "nhwc"
                                      else qt + 4 * e)
                    col = qt + 4 * j
                    assert channel_at[8 * kk + col] == ch, (lane, kk, col)
                    for hf in range(2):                 # rows qg, qg + 8
                        got[qg + 8 * hf] += x[qg + 8 * hf, ch] * w[
                            channel_at[8 * kk + col]]
    np.testing.assert_allclose(got, x @ w, rtol=1e-12)


@pytest.mark.parametrize("W", [160, 84, 56, 20, 16, 33, 13, 5])
def test_bf16_nchw_stores_cover_each_row_once(W):
    """bf16's NCHW epilogue: lanes qg and qg ^ 1 swap a value of each
    channel, so the even lane stores pixels qg, qg + 1 and the odd one
    qg + 7, qg + 8 of the warp's 16; every pixel of a channel's row is
    stored once. Where W is even (the source's condition for the 4-byte
    store) each pair starts at an even element, 4-byte aligned, and lies
    in x whole or not at all."""
    assert "if (R == kNchwTma || (g.W & 1) == 0) {" in CSRC
    H, B, C = 3, 2, 64
    plane = H * W
    for w0 in range(0, W, 16):
        stored = {}
        for lane in range(32):
            qg, qt = divmod(lane, 4)
            odd = qg & 1
            # a lane holds pixels qg (y0) and qg + 8 (y1), accumulator rows;
            # lane ^ 4 (row qg ^ 1) sends its y1 where even, its y0 where odd
            partner = qg ^ 1
            sent = partner if partner & 1 else partner + 8
            lo, hi = (sent, qg + 8) if odd else (qg, sent)
            wcol = w0 + (qg + 7 if odd else qg)
            assert (lo, hi) == (wcol - w0, wcol - w0 + 1), lane
            for jj in range(8):
                for e in range(2):
                    co = 8 * jj + 2 * qt + e
                    off = ((B - 1) * C + co) * plane + (H - 1) * W + wcol
                    if W % 2 == 0:
                        assert off % 2 == 0
                        assert (wcol < W) == (wcol + 1 < W)
                    for px in (wcol, wcol + 1):
                        if px < W:
                            stored[co, px] = stored.get((co, px), 0) + 1
        want = {(co, px): 1 for co in range(C)
                for px in range(w0, min(w0 + 16, W))}
        assert stored == want


# ---- (c) the layout each fused conv receives ----------------------------------

PX = 64


@pytest.fixture
def record(monkeypatch):
    """The route of every fused conv call on the CPU path (the wrapper and
    the custom operator's CPU kernel both call the plain version)."""
    seen = []
    plain = packed_conv.conv3x3_bn_silu_reference

    def rec(x, w, scale, bias):
        seen.append(packed_conv.route(x))
        return plain(x, w, scale, bias)
    monkeypatch.setattr(packed_conv, "conv3x3_bn_silu_reference", rec)
    return seen


@pytest.fixture(scope="module")
def tiny():
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    return build_model(tiny_icafusion_config(),
                       generator=torch.Generator().manual_seed(0)).eval()


def _pair(B=2):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.rand(B, 3, PX, PX, generator=g) for _ in range(2))


def _uint8_pair(B=2):
    rng = np.random.default_rng(5)
    return tuple(rng.integers(0, 256, (B, PX, PX, 3), np.uint8)
                 for _ in range(2))


def _assert_all(seen, channels_last: bool):
    assert seen, "no fused conv ran"
    assert all((r == "nhwc") == channels_last for r in seen), seen


def test_engine_and_evaluator_give_channels_last(tiny, record):
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.serve.engine import ServingEngine
    ServingEngine(tiny, PX, 2, dtype="float32",
                  device="cpu").predict_arrays(*_uint8_pair())
    _assert_all(record, True)
    record.clear()
    Evaluator(tiny, nc=3, device="cpu")._infer(*_uint8_pair())
    _assert_all(record, True)


def test_fit_gives_channels_last(record, tmp_path, monkeypatch):
    """fit's evaluations (the fused conv runs in eval mode only). No
    TensorBoard writer and no plots: they cost more than the epoch."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.data.synthetic import make_dataset
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    from icafusion_tpu_torch.train import fit as fit_module
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    from icafusion_tpu_torch.utils.loggers import Loggers
    monkeypatch.setattr(Loggers, "_make_tb_writer", lambda self: None)
    for name in ("plot_confusion_matrix", "plot_images", "plot_labels",
                 "plot_results"):
        monkeypatch.setattr(fit_module, name, lambda *a, **k: None)
    data = make_dataset(tmp_path / "data", 6, np.random.default_rng(0),
                        hw=(PX, PX))
    fit(FitConfig(model_cfg=tiny_icafusion_config(nc=3),
                  data_cfg=load_data_config(data), hyp=load_hyp_config(),
                  epochs=1, batch_size=4, imgsz=PX, project=str(tmp_path),
                  workers=0, warmup_min_steps=1, max_targets=16,
                  device="cpu"))
    _assert_all(record, True)


def test_program_gradcam_ensemble_and_hub_give_nchw(tiny, record):
    """An ordinary (B, 3, H, W) tensor is NCHW, and cuDNN keeps its layout
    through the convs, so every fused conv after it sees NCHW: a .pt2
    program's icafusion::conv3x3_bn_silu nodes, Grad-CAM (under grad),
    ensemble_predict and a hub.create model."""
    from icafusion_tpu_torch import hub
    from icafusion_tpu_torch.cli.export import export_program
    from icafusion_tpu_torch.models.ensemble import ensemble_predict
    from icafusion_tpu_torch.models.gradcam import (default_cam_layers,
                                                    gradcam_saliency)
    x, y = _pair()
    program = export_program(tiny, 2, PX)
    record.clear()                       # tracing runs no kernel
    with torch.no_grad():
        program.module()(x, y)
    _assert_all(record, False)
    record.clear()
    gradcam_saliency(tiny, x, y, default_cam_layers(tiny.cfg)[0])
    _assert_all(record, False)
    record.clear()
    with torch.no_grad():
        ensemble_predict([tiny, tiny], x, y)
    _assert_all(record, False)
    record.clear()
    with torch.no_grad():
        hub.create("icafusion_tiny").eval()(x, y)
    _assert_all(record, False)
