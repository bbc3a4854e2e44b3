"""The launch plan of the port's int8 conv (kernels/conv_int8.py: plan) and
tiled emulations of its "tma", "stem" and "grouped" kernels' loop orders,
on the CPU.

The plan is checked at every int8 conv of all shipped configs at 640 and
320 px and at B = 1, 4 and 32, with the conv shapes taken from a forward of
each model on the meta device. The tma emulation repeats in PyTorch what a
block of csrc/conv_int8.cu does (its window quantized once, the taps as
shifted windows, channel chunks zero-padded past Cin, split-K int32
partials summed in a shuffled order); the stem and grouped emulations
what a block of csrc/conv_int8_small.cu does (the window's origin and
halo, the stem's window rows and packed k32 steps read at byte offsets,
the grouped kernel's group chunks and pixel strips). Each must give the
plain version's int32 accumulators exactly. The repaired producers
(Upsample and the fusion block's residual) must hand the int8 convs
channels_last maps."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.kernels import conv_int8 as ci
from icafusion_tpu_torch.kernels import cross_attention
from icafusion_tpu_torch.models import assembler
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.detect import Detect
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.nn import fusion
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.utils.quantize import (calibrate, detect_feeder_skip,
                                                int8_conv_names,
                                                quantize_model)

torch.set_num_threads(1)

YAMLS = sorted(p.name for p in (Path(__file__).resolve().parents[1]
                                / "configs" / "models").glob("*.yaml"))
BATCHES = (1, 4, 32)


class _Stop(Exception):
    pass


def _int8_conv_shapes(name: str, size: int):
    """{(Cin, Cout, k, s, H, W, groups)}: the int8 convs of config ``name`` at
    ``size`` px, batch 1, from a forward on the meta device that stops at
    Detect (train mode: the eval-only fused conv has no meta version; the
    shapes are the same)."""
    cfg = load_model_config(name)
    with torch.device("meta"):
        model = assembler.ICAFusionModel(cfg).train()
    names = set(int8_conv_names(model, detect_feeder_skip(cfg)))
    by_mod = {m: n for n, m in model.named_modules()}
    shapes = set()

    def record(mod, args):
        if by_mod[mod] in names:
            x = args[0]
            shapes.add((x.shape[1], mod.conv.out_channels,
                        mod.conv.kernel_size[0], mod.conv.stride[0],
                        *x.shape[2:], mod.conv.groups))

    def stop(mod, args):
        raise _Stop

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Conv)]
    hooks += [m.register_forward_pre_hook(stop) for m in model.modules()
              if isinstance(m, Detect)]
    x = torch.empty(1, 3, size, size, device="meta").contiguous(
        memory_format=torch.channels_last)
    try:
        with torch.no_grad():
            model(x, x)
    except _Stop:
        pass
    for h in hooks:
        h.remove()
    assert len(shapes) > 5
    return shapes


@pytest.fixture
def meta_attention(monkeypatch):
    """The plain attention in the fusion blocks: it runs on the meta
    device (the wrapper takes CPU or CUDA tensors only)."""
    monkeypatch.setattr(fusion, "dual_cross_attention",
                        cross_attention.dual_cross_attention_reference)


def _check_layout(pl, k, s):
    """The shared-memory regions csrc/conv_int8.cu is handed follow one
    another without overlap, each aligned as the kernel addresses it, and a
    window copy holds the rows the kernel writes and the deepest tap reads
    (the entry's own checks, which refuse a launch otherwise)."""
    lay = pl.layout
    th, tw = pl.tile
    lift = (k - 1) // s
    ring = pl.b_stages * ci.N_TILE * ci.Q_CH
    assert lay.copy_bytes % (8 * ci.Q_CH) == 0       # whole swizzle atoms
    assert lay.copy_bytes >= ci.Q_CH * max((th + lift) * tw,
                                           ci.M_SLOTS + lift * tw)
    assert lay.off_q % 1024 == 0 and lay.off_q >= ring
    assert lay.off_ep >= lay.off_q + pl.chunks * k * s * lay.copy_bytes
    assert lay.off_ep % 16 == 0
    assert lay.off_bar >= lay.off_ep + pl.n_per_group * ci.N_TILE * 8
    assert lay.off_bar % 8 == 0
    assert 1024 + lay.off_bar + 128 <= lay.smem <= ci.SMEM_MAX


def _check_small_plan(pl, B, Cin, Cout, k, s, Ho, Wo, g=1):
    """A "stem" or "grouped" plan: the tile within its pixel slots, the
    window the tile's receptive field, the tiles and grid they claim, the
    shared memory within the H100's 232 448 bytes a block."""
    th, tw = pl.tile
    assert pl.halo == ((th - 1) * s + k, (tw - 1) * s + k)
    assert pl.tiles == B * -(-Ho // th) * -(-Wo // tw)
    assert pl.smem <= ci.SMEM_MAX, (B, Cin, Cout, k, s, pl)
    if pl.path == "stem":
        assert 1 <= th * tw <= ci.STEM_SLOTS
        assert ci.stem_items(Cin, k, k, s, pl.tile) <= ci.STEM_ITEMS
        assert pl.smem == ci.stem_smem(Cin, Cout, k, k, s, pl.tile)
        assert pl.grid == min(pl.tiles, ci.SMS * ci.STEM_BLOCKS)
    else:
        assert 1 <= th * tw <= ci.GROUPED_SLOTS and tw % ci.GROUPED_R == 0
        assert pl.groups == ci.grouped_chunk(Cin // g, Cout // g, g)
        assert pl.groups * (Cout // g) <= max(ci.GROUPED_COUT, Cout // g)
        assert pl.grid == pl.tiles * -(-g // pl.groups)
        assert pl.smem == ci.grouped_smem(Cin // g, Cout // g, k, k, s,
                                          pl.tile, pl.groups)


def _check_plan(B, shape):
    Cin, Cout, k, s, H, W, g = shape
    p = 2 if k == 6 else k // 2
    pl = ci.plan(B, Cin, H, W, Cout, k, k, s, p, conv_groups=g)
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    if g > 1 or Cin % 16:              # grouped convs; the stems (Cin 3)
        assert pl.path == ("grouped" if g > 1 else "stem"), (shape, pl)
        _check_small_plan(pl, B, Cin, Cout, k, s, Ho, Wo, g)
        return pl
    assert pl.path == "tma", (shape, pl.reason)
    th, tw = pl.tile
    assert 1 <= th * tw <= ci.M_SLOTS
    if (k - 1) // s:
        assert tw % 8 == 0, (shape, pl.tile)   # operands on a swizzle atom
    # the window covers the receptive field of the tile
    assert pl.halo == ((th - 1) * s + k, (tw - 1) * s + k)
    rows_needed = (th - 1) * s + k          # input rows of th output rows
    assert pl.halo[0] >= rows_needed and pl.halo[1] >= (tw - 1) * s + k
    assert pl.tiles == B * -(-Ho // th) * -(-Wo // tw)
    # shared memory
    assert pl.smem <= ci.SMEM_MAX, (shape, B, pl.smem)
    assert pl.layout == ci.layout(pl.tile, k, k, s, pl.chunks,
                                  pl.n_per_group, pl.b_stages)
    _check_layout(pl, k, s)
    # the grid and the split of Cin
    U = -(-Cin // ci.UNIT)
    assert pl.splits == -(-U // pl.slice_units)
    assert (pl.splits - 1) * pl.slice_units < U
    assert pl.chunks * ci.Q_CH >= pl.slice_units * ci.UNIT
    n_tiles = -(-Cout // ci.N_TILE)
    assert pl.groups == -(-n_tiles // pl.n_per_group)
    assert pl.grid == pl.tiles * pl.groups * pl.splits
    if pl.groups > 1:       # groups only where the tiles leave SMs idle
        assert pl.tiles * (pl.groups - 1) < ci.SMS, (shape, B, pl)
    forced = max(u for u in range(1, U + 1)
                 if ci._ring((pl.tile, k, k, s), -(-(u * ci.UNIT) // ci.Q_CH),
                             pl.n_per_group) is not None)
    if pl.slice_units < forced:
        # a split that shared memory does not force: only where the tiles
        # and groups leave most SMs idle, and then it brings the grid to
        # at least half of SPLIT_FILL blocks (or cuts Cin to single units)
        busy = pl.tiles * pl.groups
        assert busy < ci.SPLIT_BELOW, (shape, B, pl)
        assert Cin >= ci.SPLIT_CIN or busy < ci.SPLIT_IDLE, (shape, B, pl)
        assert (pl.grid >= ci.SPLIT_FILL // 2 or pl.slice_units == 1), (
            shape, B, pl)
    return pl


@pytest.mark.parametrize("size", [640, 320])
@pytest.mark.parametrize("name", YAMLS)
def test_plan_at_every_int8_conv_of_every_config(meta_attention, name, size):
    """At B = 1, 4 and 32 every small-Cin int8 conv (the stems) takes the
    "stem" path, every grouped one the "grouped" path and every other one
    the "tma" path, none the first design's direct path; shared memory
    within the H100's 232 448 bytes a block; the window the tile's
    receptive field; the grid the tiles x groups x splits it claims (tma),
    the tiles or the persistent blocks (stem), the tiles x group chunks
    (grouped); groups and splits only where the output tiles leave the
    card idle."""
    shapes = sorted(_int8_conv_shapes(name, size))
    for sh in shapes:       # the small-Cin ones: yolov5's stems, n to x
        assert sh[0] % 16 == 0 or sh[:4] in {(3, c, 6, 2) for c in
                                             (16, 32, 48, 64, 80)}, sh
    for shape in shapes:
        for B in BATCHES:
            _check_plan(B, shape)


def test_weight_box_within_tma_limits():
    """The one TMA box, a weight tile (Cin bytes, tap, Cout) = (Q_CH, 1,
    N_TILE): every extent at most 256 and the inner one a multiple of 16
    bytes, and it fills the 128-byte swizzle exactly."""
    box = (ci.Q_CH, 1, ci.N_TILE)
    assert all(1 <= d <= 256 for d in box)      # TMA's largest extent
    assert box[0] % 16 == 0 and box[0] == 128      # int8: bytes = elements


def test_plan_routes_what_the_tma_path_does_not_take():
    """The stem (in any strides) and a channels_last Cin % 16 take the
    stem path; NCHW, a misaligned or odd-strided view with Cin >= 16,
    Cout % 8 and stride 3 go to the direct path; a channels_last view with
    a 16-byte aligned channel offset stays on the tma path."""
    assert ci.plan(4, 3, 640, 640, 64, 6, 6, 2, 2).path == "stem"
    stem_nchw = (3 * 640 * 640, 640 * 640, 640, 1)
    assert ci.plan(4, 3, 640, 640, 64, 6, 6, 2, 2,
                   strides=stem_nchw).path == "stem"
    engine_view = (640 * 640 * 3, 1, 640 * 3, 3)    # uint8 NHWC, permuted
    assert ci.plan(4, 3, 640, 640, 64, 6, 6, 2, 2, strides=engine_view,
                   aligned=False).path == "stem"
    assert ci.plan(4, 6, 640, 640, 128, 6, 6, 2, 2).path == "stem"
    nchw = (64 * 40 * 40, 40 * 40, 40, 1)
    assert ci.plan(4, 64, 40, 40, 64, 3, 3, 1, 1, strides=nchw).path == \
        "direct"
    assert ci.plan(4, 40, 20, 20, 64, 3, 3, 1, 1,
                   strides=(40 * 400, 400, 20, 1)).path == "direct"
    assert ci.plan(4, 48, 20, 20, 64, 1, 1, aligned=False).path == "direct"
    assert ci.plan(4, 40, 20, 20, 64, 1, 1).path == "stem"      # Cin % 16
    assert ci.plan(4, 64, 20, 20, 60, 1, 1).path == "direct"    # Cout % 8
    assert ci.plan(4, 3, 64, 64, 60, 6, 6, 2, 2).path == "direct"
    assert ci.plan(4, 64, 20, 20, 64, 3, 3, 3, 1).path == "direct"
    assert ci.plan(4, 3, 64, 64, 64, 6, 6, 3, 2).path == "direct"
    assert ci.plan(4, 3, 64, 64, 64, 6, 6, 2, 2,
                   torch.float16).path == "direct"
    full = torch.zeros(2, 96, 9, 7).contiguous(
        memory_format=torch.channels_last)
    view = full[:, 16:80]
    assert view.stride(1) == 1
    w8 = torch.zeros(64, 3, 3, 64, dtype=torch.int8)
    assert ci.plan_for(view, w8, 1, 1).path == "tma"
    assert ci.plan_for(full[:, 2:66], w8, 1, 1).path == "direct"   # 8 bytes
    assert ci.plan_for(view.contiguous(), w8, 1, 1).path == "direct"


def _emulate(x, w8, s_in, stride, padding, pl, rng):
    """The tma kernel's int32 sums, block by block, in its loop order: each
    (tile, group, split) block quantizes its window once (the zero padding
    quantizes to 0), reads every tap as a shifted window of it, walks the
    slice's channels in 128-channel chunks zero-padded past Cin, and
    writes an int32 partial; the partials of a tile are summed in a
    shuffled order."""
    B, Cin, H, W = x.shape
    Cout, kh, kw, _ = w8.shape
    s, p = stride, padding
    Ho, Wo = (H + 2 * p - kh) // s + 1, (W + 2 * p - kw) // s + 1
    th, tw = pl.tile
    hh, hw = pl.halo
    x8 = ci.quantize_input(x, s_in).to(torch.int64)      # (B, Cin, H, W)
    w = w8.to(torch.int64)                                # (Cout, kh, kw, Cin)
    chunks = -(-(pl.splits * pl.slice_units * ci.UNIT) // ci.Q_CH)
    cpad = (chunks + 1) * ci.Q_CH       # room for a chunk past Cin
    tiles_w, tiles_h = -(-Wo // tw), -(-Ho // th)
    out = torch.zeros(B, Cout, Ho, Wo, dtype=torch.int64)
    npg = pl.n_per_group
    for tile in range(pl.tiles):
        b = tile // (tiles_w * tiles_h)
        h0 = (tile // tiles_w % tiles_h) * th
        w0 = (tile % tiles_w) * tw
        # the window, quantized once: rows h0*s - p .., zero outside x
        win = torch.zeros(cpad, hh, hw, dtype=torch.int64)
        r0, c0 = h0 * s - p, w0 * s - p
        ra, rb = max(r0, 0), min(r0 + hh, H)
        ca, cb = max(c0, 0), min(c0 + hw, W)
        if ra < rb and ca < cb:
            win[:Cin, ra - r0:rb - r0, ca - c0:cb - c0] = x8[b, :, ra:rb, ca:cb]
        for g in range(pl.groups):
            cols = range(g * npg * ci.N_TILE,
                         min(Cout, (g + 1) * npg * ci.N_TILE))
            partials = []
            for split in range(pl.splits):
                lo = split * pl.slice_units * ci.UNIT
                hi = min(Cin, lo + pl.slice_units * ci.UNIT)
                acc = torch.zeros(len(cols), th, tw, dtype=torch.int64)
                for q0 in range(lo, hi, ci.Q_CH):       # 128-channel chunks
                    q1 = q0 + ci.Q_CH
                    wq = torch.zeros(len(cols), kh, kw, ci.Q_CH,
                                     dtype=torch.int64)
                    real = min(q1, Cin, hi) - q0
                    wq[..., :real] = w[cols.start:cols.stop, :, :,
                                       q0:q0 + real]
                    for ky in range(kh):
                        for kx in range(kw):
                            a = win[q0:q1, ky:ky + (th - 1) * s + 1:s,
                                    kx:kx + (tw - 1) * s + 1:s]
                            a = a.clone()
                            a[max(0, min(Cin, hi) - q0):] = 0
                            acc += torch.einsum("chw,oc->ohw", a,
                                                wq[:, ky, kx])
                partials.append(acc)
            total = torch.zeros_like(partials[0])
            for i in rng.permutation(len(partials)):
                total += partials[i]
            hs, ws = min(th, Ho - h0), min(tw, Wo - w0)
            out[b, cols.start:cols.stop, h0:h0 + hs, w0:w0 + ws] = \
                total[:, :hs, :ws]
    assert out.abs().max() < 2 ** 31
    return out.to(torch.int32)


@contextlib.contextmanager
def _sms(n: int):
    """plan() on a card of n SMs (few SMs force splits at small shapes)."""
    real = ci.SMS
    ci.plan.cache_clear()
    ci.SMS = n
    try:
        yield
    finally:
        ci.SMS = real
        ci.plan.cache_clear()


EMULATED = [  # (B, Cin, Cout, k, s, H, W, sms): sms small to force splits
    (2, 48, 40, 3, 1, 9, 13, 132),      # Cin 48: a padded chunk
    (1, 64, 136, 3, 2, 11, 10, 132),    # stride 2, two output tiles
    (2, 32, 16, 1, 1, 7, 5, 132),       # 1x1, ragged
    (1, 80, 24, 3, 1, 6, 9, 4),         # split-K over 32-channel units
    (2, 160, 264, 1, 1, 5, 6, 6),       # groups and splits, Cout past 256
    (1, 96, 64, 3, 2, 13, 17, 8),       # stride 2 with splits
]


@pytest.mark.parametrize("case", EMULATED)
def test_tiled_emulation_equals_the_plain_accumulators(case):
    B, Cin, Cout, k, s, H, W, sms = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(0, 1, (B, Cin, H, W)).astype(np.float32))
    x = x.to(torch.bfloat16).float().contiguous(
        memory_format=torch.channels_last)
    s_in = (x.abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-8)
    w8 = torch.from_numpy(rng.integers(-127, 128, (Cout, k, k, Cin))
                          .astype(np.int8))
    p = k // 2
    with _sms(sms):
        pl = ci.plan_for(x, w8, s, p)
    assert pl.path == "tma"
    if sms < 132:
        assert pl.splits > 1, pl
    got = _emulate(x, w8, s_in, s, p, pl, rng)
    want = ci.conv_int8_bn_act_reference(x, w8, s_in, None, None, s, p,
                                         epilogue=False)
    assert torch.equal(got, want)


def test_int8_convs_see_channels_last_maps():
    """The tiny model quantized and run in eval mode on a channels_last
    pair: every int8 conv's input is channels_last (Upsample and the
    fusion residual keep the layout), and the stem is the only input with
    fewer than 16 channels."""
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pair = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2)]
    quantize_model(model, calibrate(model, [pair]),
                   skip=detect_feeder_skip(model.cfg))
    model.eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append(a[0])) for m in model.modules()
        if isinstance(m, Conv) and m.w8 is not None]
    x, y = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in pair)
    with torch.inference_mode():
        model(x, y)
    for h in hooks:
        h.remove()
    assert len(seen) == 84
    for t in seen:
        assert t.is_contiguous(memory_format=torch.channels_last), t.shape
    assert sum(t.shape[1] < 16 for t in seen) == 2      # the two stems


def _r16(v):
    return -(-v // 16) * 16


def _tiles(pl, Ho, Wo):
    """(b, h0, w0) of each of plan ``pl``'s tiles, in the kernels' order."""
    th, tw = pl.tile
    tiles_w, tiles_h = -(-Wo // tw), -(-Ho // th)
    for t in range(pl.tiles):
        yield (t // (tiles_w * tiles_h), (t // tiles_w % tiles_h) * th,
               t % tiles_w * tw)


def _window(x8, b, r0, c0, hh, hw, channels):
    """x8[b, channels] rows r0 .., columns c0 .. of a (hh, hw) window as
    (hh, hw, C), zeros outside x (the conv's padding)."""
    _, _, H, W = x8.shape
    win = np.zeros((hh, hw, len(channels)), np.int64)
    ra, rb = max(r0, 0), min(r0 + hh, H)
    ca, cb = max(c0, 0), min(c0 + hw, W)
    if ra < rb and ca < cb:
        win[ra - r0:rb - r0, ca - c0:cb - c0] = \
            x8[b, channels][:, ra:rb, ca:cb].transpose(1, 2, 0)
    return win


def _emulate_stem(x, w8, s_in, s, p, pl, rng):
    """The stem kernel's int32 sums, tile by tile: the window quantized
    once into rows of (pixel, channel) bytes at a 16-byte pitch (its
    unwritten bytes hold noise, as shared memory does); the weights as
    kh * ceil(kw * Cin / 4) groups of 4 bytes (zeros past a tap row),
    packed 8 to a k32 step; slot i = (r, c) of STEM_SLOTS reads group G's
    4 bytes at r * s * pitch + c * s * Cin + (ky * pitch + 4 * gi), G = ky
    * Gr + gi, which past the tap row's run meet zero weights."""
    B, Cin, H, W = x.shape
    Cout, kh, kw, _ = w8.shape
    Ho, Wo = (H + 2 * p - kh) // s + 1, (W + 2 * p - kw) // s + 1
    th, tw = pl.tile
    hh, hw = pl.halo
    x8 = ci.quantize_input(x, s_in).to(torch.int64).numpy()
    kwc, Gr = kw * Cin, -(-(kw * Cin) // 4)
    steps = ci.stem_steps(Cin, kh, kw)
    assert steps == -(-(kh * Gr) // 8)
    wk = np.zeros((Cout, steps * 32), np.int64)
    rows = w8.to(torch.int64).numpy().reshape(Cout, kh, kwc)
    tab = np.zeros(steps * 8, np.int64)
    Lp = _r16(hw * Cin)
    for G in range(kh * Gr):
        ky, gi = divmod(G, Gr)
        tab[G] = ky * Lp + 4 * gi
        for j in range(4):
            if 4 * gi + j < kwc:
                wk[:, 4 * G + j] = rows[:, ky, 4 * gi + j]
    i = np.arange(ci.STEM_SLOTS)
    i = np.where(i < th * tw, i, 0)          # slots past the tile: slot 0
    base = (i // tw) * s * Lp + (i % tw) * s * Cin
    idx = (base[:, None] + np.repeat(tab, 4)[None]
           + np.tile(np.arange(4), steps * 8)[None])
    out = np.zeros((B, Cout, Ho, Wo), np.int64)
    for b, h0, w0 in _tiles(pl, Ho, Wo):
        win = rng.integers(-128, 128, hh * Lp + 64)
        rowsw = _window(x8, b, h0 * s - p, w0 * s - p, hh, hw, range(Cin))
        for r in range(hh):
            win[r * Lp:r * Lp + hw * Cin] = rowsw[r].reshape(-1)
        acc = win[idx] @ wk.T                        # (slots, Cout)
        for k in range(th * tw):
            r, c = divmod(k, tw)
            if h0 + r < Ho and w0 + c < Wo:
                out[b, :, h0 + r, w0 + c] = acc[k]
    assert np.abs(out).max() < 2 ** 31
    return torch.from_numpy(out).to(torch.int32)


# (B, Cin, Cout, k, s, H, W): the stems of n and l on ragged maps, the
# merged stem's Cin 6, Focus's 12 at 3x3, a 7x7 of Cin 5, Cout past one
# 64-channel pass, Cin 40 (a channels_last Cin % 16 of the stem path)
STEM_EMULATED = [(2, 3, 16, 6, 2, 37, 45), (1, 3, 64, 6, 2, 50, 66),
                 (1, 6, 24, 6, 2, 29, 33), (2, 12, 8, 3, 1, 13, 11),
                 (1, 5, 16, 7, 2, 23, 19), (2, 3, 136, 3, 2, 17, 21),
                 (1, 40, 16, 3, 1, 9, 11)]


@pytest.mark.parametrize("case", STEM_EMULATED)
def test_stem_tiling_emulation_equals_the_plain_accumulators(case):
    B, Cin, Cout, k, s, H, W = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(0, 1, (B, Cin, H, W)).astype(np.float32))
    x = x.to(torch.bfloat16).float().contiguous(
        memory_format=torch.channels_last)
    s_in = (x.abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-8)
    w8 = torch.from_numpy(rng.integers(-127, 128, (Cout, k, k, Cin))
                          .astype(np.int8))
    p = 2 if k == 6 else k // 2
    pl = ci.plan_for(x, w8, s, p)
    assert pl.path == "stem", pl
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    _check_small_plan(pl, B, Cin, Cout, k, s, Ho, Wo)
    got = _emulate_stem(x, w8, s_in, s, p, pl, rng)
    want = ci.conv_int8_bn_act_reference(x, w8, s_in, None, None, s, p,
                                         epilogue=False)
    assert torch.equal(got, want)


def _emulate_grouped(x, w8, s_in, s, p, g, pl):
    """The grouped kernel's int32 sums, block by block: block (tile,
    chunk) owns groups [chunk * gpc, ...) (the last chunk fewer), quantizes
    their input channels' window once, and output channel co of the chunk
    reads the window's channels of its group, (co // Cout_g) * Cin_g + j;
    a thread's strip of GROUPED_R pixels of a tile row reads the tap row's
    (R - 1) * s + kw window pixels once for all R."""
    B, Cin, H, W = x.shape
    Cout, kh, kw, Cin_g = w8.shape
    Cout_g = Cout // g
    Ho, Wo = (H + 2 * p - kh) // s + 1, (W + 2 * p - kw) // s + 1
    th, tw = pl.tile
    hh, hw = pl.halo
    R = ci.GROUPED_R
    assert tw % R == 0 and hw == (tw - 1) * s + kw
    x8 = ci.quantize_input(x, s_in).to(torch.int64).numpy()
    w = w8.to(torch.int64).numpy()
    out = np.zeros((B, Cout, Ho, Wo), np.int64)
    for b, h0, w0 in _tiles(pl, Ho, Wo):
        for g0 in range(0, g, pl.groups):
            ng = min(pl.groups, g - g0)
            ci_lo, co_lo = g0 * Cin_g, g0 * Cout_g
            win = _window(x8, b, h0 * s - p, w0 * s - p, hh, hw,
                          range(ci_lo, ci_lo + ng * Cin_g))
            for co in range(ng * Cout_g):
                c0 = co // Cout_g * Cin_g
                acc = np.zeros((th, tw), np.int64)
                for r in range(th):
                    for q in range(tw // R):
                        for ky in range(kh):
                            for j in range(Cin_g):
                                xv = win[r * s + ky, q * R * s:
                                         q * R * s + (R - 1) * s + kw, c0 + j]
                                for kx in range(kw):
                                    acc[r, q * R:(q + 1) * R] += (
                                        xv[kx:kx + (R - 1) * s + 1:s]
                                        * w[co_lo + co, ky, kx, j])
                hs, ws = min(th, Ho - h0), min(tw, Wo - w0)
                out[b, co_lo + co, h0:h0 + hs, w0:w0 + ws] = acc[:hs, :ws]
    return torch.from_numpy(out).to(torch.int32)


# (B, Cin, Cout, k, s, H, W, groups): tests/test_torch_port_int8_grouped's
# four classes, a channel multiplier of 2, 128 groups in two chunks, a
# group of 160 output channels (a chunk of one group past GROUPED_COUT)
GROUPED_EMULATED = [(2, 32, 32, 3, 1, 13, 18, 32), (2, 32, 48, 3, 2, 13, 18, 2),
                    (1, 16, 16, 5, 1, 13, 18, 16), (2, 24, 48, 1, 1, 13, 18, 4),
                    (1, 16, 32, 3, 1, 15, 10, 16),
                    (1, 128, 128, 3, 2, 11, 9, 128),
                    (1, 64, 320, 3, 1, 9, 13, 2)]


@pytest.mark.parametrize("case", GROUPED_EMULATED)
def test_grouped_tiling_emulation_equals_the_plain_accumulators(case):
    B, Cin, Cout, k, s, H, W, g = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(0, 1, (B, Cin, H, W)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    s_in = (x.abs().amax() / 127).reshape(())
    w8 = torch.from_numpy(rng.integers(-127, 128, (Cout, k, k, Cin // g))
                          .astype(np.int8))
    p = k // 2
    pl = ci.plan_for(x, w8, s, p, groups=g)
    assert pl.path == "grouped", pl
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    _check_small_plan(pl, B, Cin, Cout, k, s, Ho, Wo, g)
    got = _emulate_grouped(x, w8, s_in, s, p, g, pl)
    want = ci.conv_int8_bn_act_reference(x, w8, s_in, None, None, s, p,
                                         epilogue=False, groups=g)
    assert torch.equal(got, want)
