"""The launch plan of the port's int8 conv (kernels/conv_int8.py: plan) and
a tiled emulation of its "tma" kernel's loop order, on the CPU.

The plan is checked at every int8 conv of all shipped configs at 640 and
320 px and at B = 1, 4 and 32, with the conv shapes taken from a forward of
each model on the meta device. The emulation repeats in PyTorch what a
block of csrc/conv_int8.cu does (its window quantized once, the taps as
shifted windows, channel chunks zero-padded past Cin, split-K int32
partials summed in a shuffled order) and must give the plain version's
int32 accumulators exactly. The repaired producers (Upsample and the
fusion block's residual) must hand the int8 convs channels_last maps."""

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
    """{(Cin, Cout, k, s, H, W)}: the int8 convs of config ``name`` at
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
                        *x.shape[2:]))

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


def _check_plan(B, shape):
    Cin, Cout, k, s, H, W = shape
    p = 2 if k == 6 else k // 2
    pl = ci.plan(B, Cin, H, W, Cout, k, k, s, p)
    if Cin == 3:                       # the stems: a 6-byte channel row
        assert pl.path == "direct", (shape, pl)
        return pl
    assert pl.path == "tma", (shape, pl.reason)
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
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
    """Every int8 conv but the stem takes the "tma" path at B = 1, 4 and
    32; shared memory within the H100's 232 448 bytes a block; the weight
    the window the tile's receptive field; the
    grid the tiles x groups x splits it claims; groups and splits only
    where the output tiles leave the card idle."""
    for shape in sorted(_int8_conv_shapes(name, size)):
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
    """The stem, NCHW, a misaligned or odd-strided view, Cin % 16 and
    Cout % 8 go to the direct path; a channels_last view with a 16-byte
    aligned channel offset stays on the tma path."""
    assert ci.plan(4, 3, 640, 640, 64, 6, 6, 2, 2).path == "direct"
    nchw = (64 * 40 * 40, 40 * 40, 40, 1)
    assert ci.plan(4, 64, 40, 40, 64, 3, 3, 1, 1, strides=nchw).path == \
        "direct"
    assert ci.plan(4, 48, 20, 20, 64, 1, 1, aligned=False).path == "direct"
    assert ci.plan(4, 40, 20, 20, 64, 1, 1).path == "direct"    # Cin % 16
    assert ci.plan(4, 64, 20, 20, 60, 1, 1).path == "direct"    # Cout % 8
    assert ci.plan(4, 64, 20, 20, 64, 3, 3, 3, 1).path == "direct"
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
