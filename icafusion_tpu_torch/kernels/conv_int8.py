"""int8 W8A8 convolution with input quantization, dequantization, eval-mode
BatchNorm and SiLU in one kernel.

The JAX package runs its int8 conv through XLA, not Pallas
(``icafusion_tpu/nn/layers.py:154-176``, ``Conv._int8_conv``:
``lax.conv_general_dilated`` on int8 operands with an int32 result, then
``* s_w``, BatchNorm and the activation). PyTorch has no int8 convolution
on CUDA, so the port has its own kernels, ``csrc/conv_int8.cu`` and
``csrc/conv_int8_small.cu``, with four paths that ``plan`` chooses between:

- ``"tma"``, the serving path: x float32 or bfloat16 with its channels
  innermost (channels_last, or a channels_last view with a 16-byte aligned
  channel offset), ``Cin % 16 == 0``, ``Cout % 8 == 0``, stride 1 or 2. A
  block quantizes its output tile's input window (with the halo) once into
  shared memory and multiplies it with s8 ``wgmma`` against weight tiles
  that stream through a TMA ring; Cout and K are spread over more blocks
  where the output tiles alone leave the card idle (``plan``).
- ``"stem"``: groups 1 and ``Cin % 16 != 0`` (the 3-channel stem, the
  merged stem's 6, Focus's 12) where Cin < 16 (any strides) or the map is
  laid out as the tma path wants it; stride 1 or 2, ``Cout % 8 == 0``.
  Persistent blocks walk 128-pixel tiles; each quantizes its window once
  into shared memory, in x's channels_last byte order, which makes a tap
  row's operand a contiguous run of it: ``mma.sync`` m16n8k32 reads A from
  the window itself (no im2col), 4 bytes at a time from any offset,
  against weights resident in shared memory (each tap row in groups of 4
  bytes, zeros past its end, the groups packed 8 to a k32 step); the next
  tile's window is loaded while the current one computes and is stored.
- ``"grouped"``: every conv with groups > 1 at stride 1 or 2 and kw 1, 3,
  5 or 7. A block owns a tile of pixels and a chunk of whole groups,
  quantizes the chunk's window once, and accumulates exactly in int32 on
  the CUDA cores (a depthwise conv is bytes-bound: tensor cores buy
  nothing there).
- ``"direct"``, the first design: everything else (NCHW or misaligned maps
  with Cin >= 16, strides other than 1 or 2, ``Cout % 8 != 0``, grouped
  convs with another kw or a group of more than 256 channels): an implicit
  GEMM on ``mma.sync`` m16n8k32 tiles that quantizes x in its operand
  load; a block's output channels lie in one group.

``conv_int8_bn_act`` launches the kernel on CUDA tensors and runs
``conv_int8_bn_act_reference``, the plain PyTorch version, on CPU tensors
only. Both compute

    x8  = clip(round_half_even(x / s_in[ci]), -127, 127)      (fp32 division)
    acc = conv(x8, w8)                                         (exact, int32)
    out = act(acc * mult + add)                                (fp32)
    mult = s_w * gamma / sqrt(var + eps), add = beta - mean * gamma / sqrt(..)

with the arithmetic of the epilogue in that order, rounded once to x's
dtype; ``epilogue=False`` returns ``acc`` itself. x is (B, Cin, H, W) in
any strides (channels_last on the serving path); the output is
channels_last. With ``groups`` g, output channel co reads the input
channels of its group, [(co // (Cout / g)) * Cin / g, ... + Cin / g).

The conv has no gradient: on either device ``conv_int8_bn_act`` raises
where grad is enabled and an input requires it (JAX's ``round`` gives
zero gradients silently). While ``torch.export`` traces, the call is the
custom operator ``icafusion::conv_int8_bn_act`` (kernels/ops.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import _build

BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(map(int, v))


def quantize_input(x: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """x8 as float32 values: round half to even of the fp32 quotient
    (torch.round, as jnp.round), clamped to [-127, 127]."""
    s = s_in.float().reshape(-1, 1, 1) if s_in.dim() else s_in.float()
    return torch.clamp(torch.round(x.float() / s), -127, 127)


def fold_epilogue(s_w: torch.Tensor, bn: BN):
    """(mult, add) per output channel, in the kernel's fp32 order."""
    gamma, beta, mean, var, eps = bn
    g = gamma.float() * (1.0 / torch.sqrt(var.float() + eps))
    return s_w.float() * g, beta.float() - mean.float() * g


def conv_int8_bn_act_reference(x, w8, s_in, s_w, bn: BN, stride=1,
                               padding=0, act: bool = True,
                               epilogue: bool = True, groups: int = 1):
    """The plain version: quantize, convolve the int8 values in float64
    (exact: |acc| < 2^53), cast to int32, then the fp32 epilogue."""
    x8 = quantize_input(x, s_in).double()
    w = w8.permute(0, 3, 1, 2).double()
    acc = F.conv2d(x8, w, stride=_pair(stride), padding=_pair(padding),
                   groups=groups)
    acc = acc.to(torch.int32).contiguous(memory_format=torch.channels_last)
    if not epilogue:
        return acc
    mult, add = fold_epilogue(s_w, bn)
    y = acc.float() * mult[:, None, None] + add[:, None, None]
    if act:
        y = F.silu(y)
    return y.to(x.dtype)


# The "tma" path's geometry. layout() places the kernel's shared memory;
# csrc/conv_int8.cu takes the offsets and only checks them.
SMS = 132                 # the H100's SMs
SMEM_MAX = 232448         # dynamic shared memory a block may opt into
SMEM_SM = 233472          # an SM's shared memory, 1 KB of it kept a block
M_SLOTS = 128             # output pixels a block: 2 warpgroups x 64 rows
N_TILE = 128              # output channels a wgmma tile
Q_CH = 128                # int8 channels a quantized row (128 bytes)
UNIT = 32                 # channels a k32 step: the split granularity
B_STAGES = (4, 3, 2)      # weight tiles (N_TILE x Q_CH bytes) in flight
# Split-K. Where the output tiles leave SMs idle, a tile's 128-channel
# output tiles may be spread over groups of blocks (each quantizes the same
# window), up to as many as cover the SMs; for each such count, where the
# blocks are still fewer than SPLIT_BELOW, Cin is split across blocks
# towards SPLIT_FILL blocks, but only where the quantization dominates a
# block (Cin >= SPLIT_CIN) or the card is nearly idle (fewer than
# SPLIT_IDLE blocks). Of those, the least waves of blocks times weight
# tiles a block streams wins, the most groups on a tie. Chosen on a sweep
# of groups x splits at the shape classes of yolov5l-Transfusion 640 at
# B = 1 and 4 on an H100 (port_probes.py int8-splits, PERF.md).
SPLIT_BELOW, SPLIT_FILL, SPLIT_CIN, SPLIT_IDLE = 100, 128, 512, 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# The "stem" and "grouped" paths (csrc/conv_int8_small.cu). Their entries
# lay out a block's shared memory themselves and refuse a launch whose
# ``shared`` bytes (stem_smem, grouped_smem: the stage sized for 4-byte
# elements) do not hold it.
STEM_THREADS = 256        # stem: threads a block
STEM_BLOCKS = 2           # stem: blocks an SM (its registers allow two)
STEM_SLOTS = 128          # stem: output pixels a tile (8 warps x 16 rows)
STEM_NC = 64              # stem: output channels a pass and a stage
STEM_ITEMS = 24           # stem: window values a thread loads ahead
SMALL_THREADS = 256       # grouped: threads a block
GROUPED_SLOTS = 128       # grouped: output pixels a tile at most
GROUPED_R = 4             # grouped: pixels a thread accumulates in a row
GROUPED_KW = (1, 3, 5, 7)
GROUPED_COUT = 64         # grouped: output channels a block (whole groups)


def _r16(v: int) -> int:
    return _cdiv(v, 16) * 16


def _window(tile: Tuple[int, int], kh: int, kw: int, s: int):
    th, tw = tile
    return (th - 1) * s + kh, (tw - 1) * s + kw


def stem_steps(Cin: int, kh: int, kw: int) -> int:
    """k32 steps of the stem's products: each tap row's kw * Cin bytes in
    groups of 4, the kh rows' groups packed 8 to a step."""
    return _cdiv(kh * _cdiv(kw * Cin, 4), 8)


def stem_smem(Cin: int, Cout: int, kh: int, kw: int, s: int,
              tile: Tuple[int, int]) -> int:
    """A "stem" block's shared memory: mult/add, the weights (Cout rows of
    stem_steps k32 steps, 16 bytes of pitch pad), the steps' window
    offsets, the int8 window (rows of hw * Cin bytes in 16-byte pitches,
    64 bytes of slack) and the stage (STEM_SLOTS pixels of STEM_NC + 8
    channels)."""
    hh, hw = _window(tile, kh, kw, s)
    steps = stem_steps(Cin, kh, kw)
    return (_r16(8 * Cout) + _r16(Cout * (steps * 32 + 16)) + steps * 32
            + _r16(hh * _r16(hw * Cin) + 64)
            + STEM_SLOTS * (STEM_NC + 8) * 4)


def stem_items(Cin: int, kh: int, kw: int, s: int,
               tile: Tuple[int, int]) -> int:
    """Window values a "stem" thread loads a tile: STEM_THREADS // Cin
    pixels a pass, one channel a thread."""
    hh, hw = _window(tile, kh, kw, s)
    return _cdiv(hh * hw, STEM_THREADS // Cin)


def _stem_tile(Ho, Wo, Cin, Cout, kh, kw, s):
    """(th, tw) with th * tw <= STEM_SLOTS, a thread's window values within
    STEM_ITEMS and the shared memory within SMEM_MAX: the fewest tiles,
    then the least window, then rows that hold whole 16-pixel mma runs,
    then the widest; None where none fits."""
    if Cin > STEM_THREADS:
        return None
    best = None
    for tw in range(1, min(Wo, STEM_SLOTS) + 1):
        th = min(Ho, STEM_SLOTS // tw)
        while th and (stem_items(Cin, kh, kw, s, (th, tw)) > STEM_ITEMS
                      or stem_smem(Cin, Cout, kh, kw, s, (th, tw))
                      > SMEM_MAX):
            th -= 1
        if not th:
            continue
        hh, hw = _window((th, tw), kh, kw, s)
        n = _cdiv(Ho, th) * _cdiv(Wo, tw)
        key = (n, n * hh * hw, tw % 16 != 0, -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    return None if best is None else best[1:]


def grouped_chunk(Cin_g: int, Cout_g: int, groups: int) -> int:
    """Groups a "grouped" block owns: as many whole groups as keep it
    within GROUPED_COUT output channels (one at least) and SMALL_THREADS
    input channels."""
    return max(1, min(groups, GROUPED_COUT // Cout_g,
                      SMALL_THREADS // Cin_g))


def grouped_smem(Cin_g: int, Cout_g: int, kh: int, kw: int, s: int,
                 tile: Tuple[int, int], gpc: int) -> int:
    """A "grouped" block's shared memory: mult/add, the weights (kh * kw *
    Cin_g x the chunk's output channels), the int8 window of the chunk's
    input channels and the stage (th * tw pixels)."""
    hh, hw = _window(tile, kh, kw, s)
    cinb, coutb = gpc * Cin_g, gpc * Cout_g
    return (_r16(8 * coutb) + _r16(kh * kw * Cin_g * coutb)
            + _r16(hh * hw * cinb) + tile[0] * tile[1] * _r16(4 * coutb))


def _grouped_tile(Ho, Wo, Cin_g, Cout_g, kh, kw, s, gpc):
    """(th, tw), tw a multiple of GROUPED_R, th * tw <= GROUPED_SLOTS,
    within SMEM_MAX: the fewest tiles, then the least window, then the
    widest; None where none fits."""
    best = None
    step = GROUPED_R
    for tw in range(step, min(_cdiv(Wo, step) * step, GROUPED_SLOTS) + 1,
                    step):
        th = min(Ho, GROUPED_SLOTS // tw)
        while th and grouped_smem(Cin_g, Cout_g, kh, kw, s, (th, tw),
                                  gpc) > SMEM_MAX:
            th -= 1
        if not th:
            continue
        hh, hw = _window((th, tw), kh, kw, s)
        n = _cdiv(Ho, th) * _cdiv(Wo, tw)
        key = (n, n * hh * hw, -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    return None if best is None else best[1:]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``conv_int8_bn_act`` launches one conv. ``path`` is "tma" (the
    serving path), "stem", "grouped" or "direct" (``reason`` says why the
    conv takes the path it takes when that is not "tma"). For "stem":
    persistent blocks (``grid`` of them) walk ``tiles`` output tiles of
    ``tile`` pixels; for "grouped" a block owns a tile and ``groups``
    conv groups (``grid`` = tiles x chunks); ``shared`` is either's dynamic
    shared memory a block. For "tma": a block
    owns ``tile`` = (th, tw) output pixels of one image (its 128 wgmma
    rows; slots past th * tw are computed and dropped) and quantizes their
    input window ``halo`` = (hh, hw) once into shared memory, then
    multiplies it with weight tiles of (Q_CH, 1, N_TILE) (Cin, tap, Cout),
    which TMA streams through a ring of ``b_stages``.
    The grid is ``tiles`` x ``groups`` (blocks across Cout, ``n_per_group``
    128-channel tiles each) x ``splits`` (blocks across Cin,
    ``slice_units`` 32-channel units each, ``chunks`` 128-channel rows a
    window pixel); a block's shared memory is laid out as ``layout`` says."""
    path: str
    reason: str = ""
    tile: Tuple[int, int] = (0, 0)
    halo: Tuple[int, int] = (0, 0)
    tiles: int = 0
    b_stages: int = 4
    groups: int = 1
    n_per_group: int = 0
    splits: int = 1
    slice_units: int = 0
    chunks: int = 0
    grid: int = 0
    layout: Optional["Layout"] = None
    shared: int = 0

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block (0 on the direct path)."""
        return self.layout.smem if self.layout else self.shared


def _tile(Ho: int, Wo: int, kh: int, kw: int, sh: int, sw: int):
    """(th, tw) with th * tw <= M_SLOTS and, where a tap reads a later
    row of a window copy, tw a multiple of 8 (its 64-row operands start on
    a swizzle atom): the fewest tiles an image, then the least window, then
    the widest rows."""
    step = 8 if (kh - 1) // sh else 1
    best = None
    for tw in range(step, min(_cdiv(Wo, step) * step, M_SLOTS) + 1, step):
        th = min(Ho, M_SLOTS // tw)
        n = _cdiv(Ho, th) * _cdiv(Wo, tw)
        key = (n, n * ((th - 1) * sh + kh) * ((tw - 1) * sw + kw), -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    return best[1], best[2]


def copy_rows(tile: Tuple[int, int], kh: int, sh: int) -> int:
    """Rows of one window copy: (th + lift) image rows of tw pixels, and
    at least the 128 slots plus the deepest tap's offset (lift * tw, lift =
    (kh - 1) // sh), in whole 8-row swizzle atoms."""
    th, tw = tile
    lift = (kh - 1) // sh
    return _cdiv(max((th + lift) * tw, M_SLOTS + lift * tw), 8) * 8


@dataclasses.dataclass(frozen=True)
class Layout:
    """A "tma" block's dynamic shared memory, in bytes from its 1 KB-aligned
    base: the weight ring at 0, then at ``off_q`` kw * sh int8 copies of
    the window (``copy_bytes`` each) per 128-channel chunk, at ``off_ep``
    mult/add of its output channels, at ``off_bar`` 16 barrier words;
    ``smem`` bytes in all with 1 KB of alignment slack."""
    copy_bytes: int
    off_q: int
    off_ep: int
    off_bar: int
    smem: int


def layout(tile: Tuple[int, int], kh: int, kw: int, sh: int, chunks: int,
           n_per_group: int, b_stages: int) -> Layout:
    copy = copy_rows(tile, kh, sh) * Q_CH
    off_q = b_stages * N_TILE * Q_CH
    off_ep = off_q + chunks * kw * sh * copy
    off_bar = off_ep + n_per_group * N_TILE * 8
    return Layout(copy, off_q, off_ep, off_bar, 1024 + off_bar + 128)


def blocks_per_sm(smem: int) -> int:
    """Resident "tma" blocks an SM (its registers allow two)."""
    return max(1, min(2, SMEM_SM // (smem + 1024)))


def _ring(geometry: tuple, chunks: int, n_per_group: int,
          blocks: int = 0) -> Optional[Tuple[int, Layout]]:
    """(b_stages, layout): the weight ring that lets the most blocks share
    an SM, the deeper one on a tie, or simply the deepest where the grid's
    ``blocks`` give an SM one block at most; None where none fits.
    ``geometry`` is layout's (tile, kh, kw, sh)."""
    fits = [(blocks_per_sm(m.smem) if blocks > SMS else 1, b, m)
            for b in B_STAGES
            for m in [layout(*geometry, chunks, n_per_group, b)]
            if m.smem <= SMEM_MAX]
    if not fits:
        return None
    _, b, m = max(fits, key=lambda f: f[:2])
    return b, m


@functools.lru_cache(maxsize=4096)   # a forward asks for the same few
def plan(B: int, Cin: int, H: int, W: int, Cout: int, kh: int, kw: int,
         stride=1, padding=0, dtype=torch.bfloat16,
         strides: Optional[Tuple[int, int, int, int]] = None,
         aligned: bool = True, conv_groups: int = 1) -> Plan:
    """The launch plan of one conv: x (B, Cin, H, W) of ``dtype`` with
    element ``strides`` (b, c, h, w; channels_last when None) and a
    16-byte aligned start (``aligned``), w8 (Cout, kh, kw, Cin /
    conv_groups). A grouped conv takes the "grouped" path, a dense conv
    with Cin % 16 != 0 the "stem" path (Cin < 16 in any strides, or a map
    the tma path could read), where their kernels take it.

    Split-K (see SPLIT_*): the block's 128-channel output tiles may be
    spread over ``groups`` blocks (each quantizes the same window) and Cin
    over ``splits`` blocks of whole 32-channel units, at least as many as
    shared memory forces. The last block to finish a tile sums the int32
    partials (exact in any order) and applies the epilogue."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    if strides is None:
        strides = (H * W * Cin, 1, W * Cin, Cin)
    direct = lambda why: Plan("direct", why)
    if dtype not in (torch.float32, torch.bfloat16):
        return direct(f"dtype {dtype}")
    if sh != sw or sh not in (1, 2):
        return direct(f"stride {(sh, sw)}")
    if conv_groups != 1:
        return _grouped_plan(B, Cin, Cout, kh, kw, sh, Ho, Wo, conv_groups)
    if Cout % 8:
        return direct(f"Cout {Cout} is not a multiple of 8")
    esz = 2 if dtype == torch.bfloat16 else 4
    if strides[1] != 1:
        unread = "channels are not innermost (NCHW or other strides)"
    elif any(s * esz % 16 for s in (strides[0], strides[2], strides[3])):
        unread = "a pixel stride is not a multiple of 16 bytes"
    else:
        unread = None if aligned else "x does not start on 16 bytes"
    if Cin % 16:
        if Cin >= 16 and unread:
            return direct(unread)
        tile = _stem_tile(Ho, Wo, Cin, Cout, kh, kw, sh)
        if tile is None:
            return direct("the stem's window or weights do not fit shared "
                          "memory")
        tiles = B * _cdiv(Ho, tile[0]) * _cdiv(Wo, tile[1])
        smem = stem_smem(Cin, Cout, kh, kw, sh, tile)
        per_sm = max(1, min(STEM_BLOCKS, SMEM_SM // (smem + 1024)))
        return Plan("stem", f"Cin {Cin} is not a multiple of 16", tile=tile,
                    halo=_window(tile, kh, kw, sh), tiles=tiles,
                    grid=min(tiles, SMS * per_sm), shared=smem)
    if unread:
        return direct(unread)
    th, tw = _tile(Ho, Wo, kh, kw, sh, sw)
    hh, hw = (th - 1) * sh + kh, (tw - 1) * sw + kw
    tiles = B * _cdiv(Ho, th) * _cdiv(Wo, tw)
    n_tiles, U = _cdiv(Cout, N_TILE), _cdiv(Cin, UNIT)
    geometry = ((th, tw), kh, kw, sh)
    choices = []
    for groups in sorted({_cdiv(n_tiles, _cdiv(n_tiles, g))
                          for g in range(1, min(n_tiles,
                                                _cdiv(SMS, tiles)) + 1)},
                         reverse=True):
        npg = _cdiv(n_tiles, groups)
        fit = [u for u in range(1, U + 1)
               if _ring(geometry, _cdiv(u * UNIT, Q_CH), npg) is not None]
        if not fit:
            continue
        units = max(fit)                # what shared memory forces
        busy = tiles * groups
        if busy < SPLIT_BELOW and (Cin >= SPLIT_CIN or busy < SPLIT_IDLE):
            # the slices whose block count comes nearest SPLIT_FILL
            units = min(range(1, units + 1), key=lambda u: (
                abs(busy * _cdiv(U, u) - SPLIT_FILL), _cdiv(U, u)))
        splits = _cdiv(U, units)
        b_stages, lay = _ring(geometry, _cdiv(units * UNIT, Q_CH), npg,
                              busy * splits)
        # waves of blocks x weight tiles a block streams (128 channels in
        # and out): the products wait on those tiles' round trips
        waves = _cdiv(busy * splits, SMS * blocks_per_sm(lay.smem))
        cost = waves * npg * _cdiv(units * UNIT, Q_CH)
        choices.append((cost, -groups, npg, units, splits, b_stages, lay))
    if not choices:
        return direct("the input window does not fit shared memory")
    _, groups, npg, units, splits, b_stages, lay = min(
        choices, key=lambda c: c[:6])
    groups = -groups
    chunks = _cdiv(units * UNIT, Q_CH)
    return Plan("tma", tile=(th, tw), halo=(hh, hw),
                tiles=tiles, b_stages=b_stages, groups=groups,
                n_per_group=npg, splits=splits,
                slice_units=units, chunks=chunks,
                grid=tiles * groups * splits, layout=lay)


def _grouped_plan(B, Cin, Cout, kh, kw, s, Ho, Wo, g) -> Plan:
    """The "grouped" plan of a conv with g groups at stride s (1 or 2), or
    "direct" where its kernel does not take it."""
    Cin_g, Cout_g = Cin // g, Cout // g
    if kw not in GROUPED_KW:
        return Plan("direct", f"grouped, kw {kw}")
    if Cin_g > SMALL_THREADS or Cout_g > SMALL_THREADS:
        return Plan("direct", "grouped, a group of more than "
                    f"{SMALL_THREADS} channels")
    gpc = grouped_chunk(Cin_g, Cout_g, g)
    tile = _grouped_tile(Ho, Wo, Cin_g, Cout_g, kh, kw, s, gpc)
    if tile is None:
        return Plan("direct", "grouped, the window does not fit shared "
                    "memory")
    tiles = B * _cdiv(Ho, tile[0]) * _cdiv(Wo, tile[1])
    return Plan("grouped", "grouped", tile=tile,
                halo=_window(tile, kh, kw, s), tiles=tiles, groups=gpc,
                grid=tiles * _cdiv(g, gpc),
                shared=grouped_smem(Cin_g, Cout_g, kh, kw, s, tile, gpc))


def plan_for(x: torch.Tensor, w8: torch.Tensor, stride=1, padding=0,
             groups: int = 1) -> Plan:
    """``plan`` of ``conv_int8_bn_act(x, w8, ..., stride, padding,
    groups=groups)`` (``groups``: the conv's)."""
    Cout, kh, kw, _ = w8.shape
    return plan(x.shape[0], x.shape[1], *x.shape[2:], Cout, kh, kw, stride,
                padding, x.dtype, tuple(x.stride()), x.data_ptr() % 16 == 0,
                groups)


# Split-K tile counters, by (device, stream): zeroed once, and every launch
# leaves them at zero (the last block of a tile resets its counter).
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, _build.stream_handle(device))
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def conv_int8_bn_act(x, w8, s_in, s_w, bn: BN, stride=1, padding=0,
                     act: bool = True, epilogue: bool = True,
                     groups: int = 1):
    """x: (B, Cin, H, W) float32 or bfloat16, any strides; w8: (Cout, kh,
    kw, Cin / groups) int8, contiguous; s_in: (Cin,) or () float32; s_w:
    (Cout,) float32; bn: (gamma, beta, running_mean, running_var, eps) of
    the BatchNorm, float32 (Cout,) each (None without the epilogue).
    Returns act(BN(conv(x8, w8) * s_w)) in x's dtype, channels_last, or
    with epilogue=False the int32 accumulators. ``plan`` picks the
    kernel's path."""
    if torch.compiler.is_exporting():
        from icafusion_tpu_torch.kernels import ops
        return ops.conv_int8_bn_act(x, w8, s_in, s_w, bn, stride, padding,
                                    act, epilogue, groups)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, s_in, s_w, *(bn or ())[:4])):
        raise RuntimeError("conv_int8_bn_act has no gradient: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.device.type == "cpu":
        return conv_int8_bn_act_reference(x, w8, s_in, s_w, bn, stride,
                                          padding, act, epilogue, groups)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return launch(x, w8, s_in, s_w, bn, stride, padding, act, epilogue,
                  groups)


def launch(x, w8, s_in, s_w, bn: BN, stride, padding, act: bool,
           epilogue: bool, groups: int):
    """Check the arguments, plan and launch on CUDA tensors, count it."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f"conv_int8_bn_act: x {tuple(x.shape)} {x.dtype}, "
                        "want (B, Cin, H, W) float32 or bfloat16")
    B, Cin, H, W = x.shape
    if (groups < 1 or w8.dtype != torch.int8 or w8.dim() != 4
            or w8.shape[3] * groups != Cin or w8.shape[0] % groups):
        raise ValueError(f"conv_int8_bn_act: w8 {tuple(w8.shape)} "
                         f"{w8.dtype}, want (Cout, kh, kw, {Cin} / {groups}) "
                         f"int8, Cout a multiple of {groups}")
    Cout, kh, kw, _ = w8.shape
    if s_in.dim() == 0:
        s_in = s_in.expand(Cin).contiguous()
    if bn is None and epilogue:
        raise ValueError("conv_int8_bn_act: the epilogue needs bn")
    bn = bn or (s_w, s_w, s_w, s_w, 0.0)
    for t, n in ((s_in, Cin), (s_w, Cout), *((t, Cout) for t in bn[:4])):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("conv_int8_bn_act: s_in is (Cin,), s_w and the "
                             "BatchNorm tensors (Cout,), all float32")
    for t in (w8, s_in, s_w, *bn[:4]):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv_int8_bn_act: w8, the scales and the "
                             "BatchNorm tensors must be contiguous and on "
                             "x's device")
    if w8.data_ptr() % 16:
        raise ValueError("conv_int8_bn_act: w8 must be 16-byte aligned")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if H + 2 * ph < kh or W + 2 * pw < kw:
        raise ValueError(f"conv_int8_bn_act: empty output for {(H, W)}, "
                         f"kernel {(kh, kw)}, padding {(ph, pw)}")
    pl = plan(B, Cin, H, W, Cout, kh, kw, (sh, sw), (ph, pw), x.dtype,
              x.stride(), x.data_ptr() % 16 == 0, groups)
    out = _launch(x, w8, s_in, s_w, bn, stride, padding, act, epilogue, pl,
                  groups)
    conv_int8_bn_act.launches += 1
    conv_int8_bn_act.stem_launches += pl.path == "stem"
    conv_int8_bn_act.grouped_launches += pl.path == "grouped"
    return out


def _launch(x, w8, s_in, s_w, bn: BN, stride, padding, act: bool,
            epilogue: bool, pl: Plan, groups: int = 1) -> torch.Tensor:
    """Launch plan ``pl`` on arguments that conv_int8_bn_act has checked
    (s_in (Cin,), bn a full tuple)."""
    B, Cin, H, W = x.shape
    Cout, kh, kw, _ = w8.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    out = torch.empty((B, Cout, Ho, Wo),
                      dtype=x.dtype if epilogue else torch.int32,
                      device=x.device, memory_format=torch.channels_last)
    lib = _build.library()
    gamma, beta, mean, var, eps = bn
    common = (w8.data_ptr(), s_in.data_ptr(), s_w.data_ptr(),
              gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
              var.data_ptr(), ctypes.c_float(eps), out.data_ptr())
    shape = (B, Cin, H, W, Cout, kh, kw, sh, sw, ph, pw, Ho, Wo,
             int(x.dtype == torch.bfloat16), int(bool(act)),
             int(bool(epilogue)))
    with torch.cuda.device(x.device):
        if pl.path == "tma":
            ws = counters = None
            if pl.splits > 1:
                ws = torch.empty((pl.splits, B, Ho, Wo, Cout),
                                 dtype=torch.int32, device=x.device)
                counters = _counters(x.device, pl.tiles * pl.groups)
            lay = pl.layout
            err = lib.icaf_conv_int8_tma(
                x.data_ptr(), *x.stride(), *common,
                ws.data_ptr() if ws is not None else None,
                counters.data_ptr() if counters is not None else None,
                *shape, *pl.tile, pl.groups, pl.splits,
                pl.slice_units, pl.chunks, pl.b_stages, lay.copy_bytes,
                lay.off_q, lay.off_ep, lay.off_bar, lay.smem,
                _build.stream_handle(x.device))
        elif pl.path == "stem":
            err = lib.icaf_conv_int8_stem(
                x.data_ptr(), *x.stride(), *common, *shape, *pl.tile,
                pl.grid, pl.shared, _build.stream_handle(x.device))
        elif pl.path == "grouped":
            err = lib.icaf_conv_int8_grouped(
                x.data_ptr(), *x.stride(), *common, *shape, groups, *pl.tile,
                pl.groups, pl.shared, _build.stream_handle(x.device))
        else:
            err = lib.icaf_conv_int8(x.data_ptr(), *x.stride(), *common,
                                     *shape, groups,
                                     _build.stream_handle(x.device))
    _build.check(err, f"conv_int8_bn_act ({pl.path})")
    return out


conv_int8_bn_act.launches = 0
conv_int8_bn_act.stem_launches = 0        # of them, on the "stem" path
conv_int8_bn_act.grouped_launches = 0     # of them, on the "grouped" path
