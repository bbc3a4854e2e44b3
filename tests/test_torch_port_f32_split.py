"""The 3xTF32 arithmetic of the port's fp32 kernels, emulated on the CPU.

The fp32 dual cross-attention (``csrc/dual_cross_attention.cu``:
``projections_tf32_kernel``, ``attention_tf32_kernel``) and the fp32
channels_last 64-channel conv (``csrc/conv3x3_bn_silu.cu``:
``conv3x3_tf32_nhwc_kernel``) multiply on tf32 tensor cores at fp32
accuracy: each operand x = big + small with big = tf32(x) and small =
tf32(x - big) (``cvt.rna``: to nearest, ties away from zero), and a b is
taken as small_a big_b + big_a small_b + big_a big_b in fp32 accumulators.
The tensor cores' fp32 accumulation truncates (toward zero) where the CUDA
cores round to nearest: on the card the kernels' errors match a truncating
emulation and not a rounding one, and over long sums the truncation fails
the gates, so the GEMMs start a fresh accumulator every few k8 steps and
add its sum to a total on the CUDA cores. The emulations here repeat all
of it in torch: the rounding by bit operations, the three products of
every k8 step in the kernels' order (small ones first), each added to its
accumulator with truncation, the totals' rounded sums, the k order, the
attention's key tiles with the online softmax's rescaling, and the
kernels' own index maps (which channel or column each fragment position
holds, on the A and the B side alike). They are held against the plain versions at the fp32 gates of
chip_smoke.py (attention rtol 2e-4 / atol 2e-5, conv 1e-4) and, at one
small shape each, against the JAX Pallas kernels in interpret mode. One
case shows why the split is kept: a single TF32 product fails the gates.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icafusion_tpu.kernels.cross_attention import \
    dual_cross_attention as jax_dual_cross_attention
from icafusion_tpu.kernels.packed_conv import pack_weights, packed_conv3x3_silu
from icafusion_tpu_torch.kernels.cross_attention import (
    NAMES, check_args, dual_cross_attention_reference)
from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu_reference
from icafusion_tpu_torch.smoke.common import (ATTN_RAGGED, ATTN_SHAPES,
                                              ATTN_SHIPPED, HEADS)

torch.set_num_threads(2)

ATTENTION_TOL = dict(rtol=2e-4, atol=2e-5)   # chip_smoke.py phase 2, fp32
CONV_TOL = dict(rtol=1e-4, atol=1e-4)        # chip_smoke.py phase 3b, fp32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, to nearest, ties away
    from zero (adding half an ulp to the magnitude bits, then truncating,
    does both for either sign)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def truncate(r: torch.Tensor) -> torch.Tensor:
    """float64 to float32 toward zero."""
    f = r.float()
    over = f.double().abs() > r.abs()   # rounded up in magnitude: one ulp
    return (f.view(torch.int32) - over.to(torch.int32)).view(torch.float32)


def mma(acc, a, b, passes: int = 3):
    """acc + a @ b for one k8 step (a (..., M, 8), b (8, N) or (..., 8, N))
    as the kernels issue it: with the split, small_a big_b, big_a small_b
    and big_a big_b, each added to the fp32 accumulator in turn (the 8
    products are exact, their sum with acc truncated to fp32); with
    passes=1 a single TF32 product, big_a big_b."""
    ab, as_ = split(a)
    bb, bs = split(b)
    terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    for x, y in terms:
        acc = truncate(acc.double() + x.double() @ y.double())
    return acc


def products(accs, a, b, passes: int = 3):
    """mma with each product in an accumulator of its own (accs: three,
    or one with passes=1), as the conv issues them."""
    ab, as_ = split(a)
    bb, bs = split(b)
    terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    return [truncate(c.double() + x.double() @ y.double())
            for c, (x, y) in zip(accs, terms)]


# ---- the attention ----------------------------------------------------------

def frag_cols(kk: int):
    """The element of an 8-wide k step that fragment position k (0..7)
    holds, in Q and K (S = Q K^T) and in P and V's rows (O = P V) alike:
    position t is element 2t and position t + 4 element 2t + 1, so that
    P's accumulator (columns 2t, 2t + 1) is its own A fragment."""
    return [8 * kk + 2 * (k % 4) + k // 4 for k in range(8)]


def kv_tile(dkp: int) -> int:
    return 32 if dkp > 192 else 64


def emulate_projection(x, w, b, passes=3):
    """x @ w.T + b as projections_tf32_kernel sums it: 32-wide stages whose
    columns past D read as 0 (TMA's zero fill), each stage's four k8 steps
    into a fresh accumulator, added to the total in fp32."""
    D = x.shape[-1]
    kp = -(-D // 32) * 32
    xp = torch.nn.functional.pad(x, (0, kp - D))
    wt = torch.nn.functional.pad(w, (0, kp - D)).t().contiguous()
    total = torch.zeros(*x.shape[:-1], w.shape[0])
    for k0 in range(0, kp, 32):
        acc = torch.zeros_like(total)
        for kk in range(k0, k0 + 32, 8):
            acc = mma(acc, xp[..., kk:kk + 8], wt[kk:kk + 8], passes)
        total = total + acc
    return total + b


def emulate_core(q, k, v, dk, passes=3):
    """softmax(q k^T / sqrt(dk)) v as attention_tf32_kernel computes it,
    for (G, N, dkp) heads padded with zeros: key tiles of 64 (32 at dkp
    256) zero past N, S over dkp / 8 k8 steps, the online softmax in the
    log2 domain (masked keys at -inf, the running max and sum rescaled by
    exp2 of the max's change), O += P V one k8 step per 8 keys, and the
    sum of each row kept as its four lanes' partials."""
    G, N, dkp = q.shape
    bkv = kv_tile(dkp)
    tiles = -(-N // bkv)
    kz = torch.zeros(G, tiles * bkv, dkp)
    vz = torch.zeros(G, tiles * bkv, dkp)
    kz[:, :N], vz[:, :N] = k, v
    scale_log2 = torch.tensor(1.4426950408889634 / math.sqrt(dk),
                              dtype=torch.float32)
    m = torch.full((G, N, 1), -math.inf)
    lanes = torch.zeros(G, N, 4)          # lane t's share of the row sum
    o = torch.zeros(G, N, dkp)
    for kt in range(tiles):
        kb = kz[:, kt * bkv:(kt + 1) * bkv]
        vb = vz[:, kt * bkv:(kt + 1) * bkv]
        s = torch.zeros(G, N, bkv)
        for kk in range(dkp // 8):
            cols = frag_cols(kk)
            s = mma(s, q[..., cols], kb[..., cols].transpose(1, 2), passes)
        s = s * scale_log2
        s[..., N - kt * bkv:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(s - m)
        # lane t holds keys 8 nb + 2t and 8 nb + 2t + 1 of the tile
        part = p.view(G, N, bkv // 8, 4, 2).sum((2, 4))
        lanes = lanes * alpha + part
        o = o * alpha
        for nb in range(bkv // 8):
            keys = frag_cols(nb)
            o = mma(o, p[..., keys], vb[:, keys], passes)
    return o * (1 / lanes.sum(-1, keepdim=True))


def emulate_attention(vis, ir, weights, biases, num_heads=HEADS, passes=3):
    """Both directions of the fp32 kernel: the six projections into a
    (6, B, h, N, dkp) scratch padded with zeros, then the core."""
    B, N, D = vis.shape
    dk = D // num_heads
    dkp = check_args(D, num_heads, torch.float32)
    qkv = torch.zeros(6, B, num_heads, N, dkp)
    for z, (x, w, b) in enumerate(zip((vis, vis, vis, ir, ir, ir), weights,
                                      biases)):
        y = emulate_projection(x, w, b, passes)
        qkv[z, ..., :dk] = y.view(B, N, num_heads, dk).transpose(1, 2)
    heads = lambda z: qkv[z].reshape(B * num_heads, N, dkp)

    def attend(zq, zk, zv):
        o = emulate_core(heads(zq), heads(zk), heads(zv), dk, passes)
        return o[..., :dk].view(B, num_heads, N, dk).transpose(1, 2).reshape(
            B, N, D)
    return attend(3, 1, 2), attend(0, 4, 5)


def attention_inputs(B, N, D, seed=0):
    """chip_smoke.py's scales: unit tokens, weights of std D^-1/2."""
    rng = np.random.default_rng(seed)
    t = lambda *s, std=1.0: torch.from_numpy(
        rng.normal(0, std, s).astype(np.float32))
    return (t(B, N, D), t(B, N, D), [t(D, D, std=D ** -0.5) for _ in NAMES],
            [t(D, std=0.1) for _ in NAMES])


def assert_attention_close(args, passes=3):
    got = emulate_attention(*args, passes=passes)
    want = dual_cross_attention_reference(*args, num_heads=HEADS)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **ATTENTION_TOL)


@pytest.mark.parametrize("N,D", ATTN_SHAPES)
def test_attention_split_holds_the_fp32_gate_at_the_flagship(N, D):
    """The flagship's three fusion levels at B = 1."""
    assert_attention_close(attention_inputs(1, N, D, seed=N))


@pytest.mark.parametrize("N,D", ATTN_SHIPPED)
def test_attention_split_holds_the_fp32_gate_at_every_shipped_width(N, D):
    """dk 8 to 256: dkp 8 (one k8 step), value columns split above 128 in
    the kernel (each column's sum is the same), key tiles of 32 at dkp
    256. N cut to 40 (a partial key tile)."""
    assert_attention_close(attention_inputs(1, 40, D, seed=D))


@pytest.mark.parametrize("N,D", ATTN_RAGGED)
def test_attention_split_holds_the_fp32_gate_at_ragged_lengths(N, D):
    """One key at dk 6 (padded to 8), and one short of and one past a
    64-key tile at dk 32, 128, 160 and 256 (32-key tiles there)."""
    assert_attention_close(attention_inputs(1, N, D, seed=N + D))


def test_attention_split_matches_pallas_interpret():
    """The JAX kernel at a small shape, its own test's inputs and
    tolerance (tests/test_torch_port_fusion.py)."""
    B, N, D = 2, 16, 64
    rng = np.random.default_rng(0)
    vis = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    ir = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    w = [rng.normal(0, 0.05, (D, D)).astype(np.float32) for _ in NAMES]
    b = [rng.normal(0, 0.01, (D,)).astype(np.float32) for _ in NAMES]
    want = jax_dual_cross_attention(
        jnp.asarray(vis), jnp.asarray(ir), *map(jnp.asarray, w),
        *map(jnp.asarray, b), num_heads=8, interpret=True)
    got = emulate_attention(torch.from_numpy(vis), torch.from_numpy(ir),
                            [torch.from_numpy(x.T.copy()) for x in w],
                            [torch.from_numpy(x) for x in b])
    for g, t in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=2e-4,
                                   atol=2e-5)


# ---- the conv ---------------------------------------------------------------

TH, TW, CO = 8, 16, 32   # the kernel's output tile and a block's channels


def frag_col(g: int) -> int:
    """conv3x3_bn_silu.cu: frag_col, the pixel column of fragment row g."""
    return (g >> 1) + 4 * (g & 1)


def weight_k(ci: int) -> int:
    """conv3x3_bn_silu.cu: weight_k, the k position of channel ci (0..31)
    in its half's 32-wide row of the weights in shared memory."""
    grp, r = ci >> 4, ci & 15
    return 8 * (2 * grp + ((r >> 1) & 1)) + (r >> 2) + 4 * (r & 1)


def a_channels(hh: int, grp: int, step: int):
    """The channel each A fragment position k holds in k8 step `step` of
    unit (half hh, 16 channels grp): lane t = k % 4 reads channels
    4 (4 grp + t) .. + 3 of the half, step 0 takes the first two as k t and
    t + 4, step 1 the last two (load_unit)."""
    return [32 * hh + 16 * grp + 4 * (k % 4) + 2 * step + k // 4
            for k in range(8)]


def b_channels(hh: int, grp: int, step: int):
    """The channel the weights hold at k8 step 2 grp + step, positions
    0..7, of half hh, as stage_weights_tf32 places them."""
    at = {weight_k(ci): ci for ci in range(32)}
    return [32 * hh + at[8 * (2 * grp + step) + k] for k in range(8)]


def emulate_conv(x, w, scale, bias, passes=3):
    """SiLU(conv3x3(x, w) * scale + bias) as conv3x3_tf32_nhwc_kernel sums
    it: per block of 32 output channels and 8 x 16 tile, halves of 32 input
    channels, taps, then 16-channel units of two k8 steps; each tap's
    three products into three fresh accumulators, added to the total in
    fp32 (the small ones first); the A side's channels from load_unit's
    map and the B side's from the weights' placement; the tiles' halos
    read zero outside x (TMA's fill). Every tile sums in the same order,
    so all tiles run at once here."""
    B, C, H, W = x.shape
    Hp, Wp = -(-H // TH) * TH, -(-W // TW) * TW
    xp = torch.zeros(B, C, Hp + 2, Wp + 2)
    xp[:, :, 1:H + 1, 1:W + 1] = x
    out = torch.zeros(B, C, H, W)
    for co0 in (0, CO):
        total = torch.zeros(B, Hp, Wp, CO)
        for hh in range(2):
            for tap in range(9):
                kh, kw = divmod(tap, 3)
                acc = [torch.zeros_like(total) for _ in range(passes)]
                for grp in range(2):
                    for step in range(2):
                        ca = a_channels(hh, grp, step)
                        cb = b_channels(hh, grp, step)
                        a = xp[:, ca, kh:kh + Hp, kw:kw + Wp].permute(
                            0, 2, 3, 1)
                        bw = w[co0:co0 + CO, cb, kh, kw].t()
                        acc = products(acc, a, bw, passes)
                total = total + (sum(acc[:-1]) + acc[-1] if passes == 3
                                 else acc[0])
        y = total[:, :H, :W].permute(0, 3, 1, 2)
        y = torch.addcmul(bias[co0:co0 + CO, None, None], y,
                          scale[co0:co0 + CO, None, None])
        out[:, co0:co0 + CO] = y / (1 + torch.exp(-y))
    return out


def conv_inputs(shape, seed=0):
    """chip_smoke.py's scales: unit activations, weights of std 1/24, a
    BatchNorm folded to scale ~ 1 + 0.3 N(0, 1) and bias ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda *s, std=1.0: torch.from_numpy(
        rng.normal(0, std, s).astype(np.float32))
    return t(*shape), t(64, 64, 3, 3, std=1 / 24), 1 + 0.3 * t(64), t(
        64, std=0.1)


def test_conv_index_maps_agree():
    """The A and B sides give every k position the same channel, each
    unit covers its 16 channels once, and the fragment rows cover the 16
    pixels of a row with quarter-warp partners 4 pixels apart."""
    for hh in range(2):
        seen = []
        for grp in range(2):
            for step in range(2):
                assert a_channels(hh, grp, step) == b_channels(hh, grp, step)
                seen += a_channels(hh, grp, step)
        assert sorted(seen) == list(range(32 * hh, 32 * hh + 32))
    cols = [frag_col(g) + 8 * hf for hf in range(2) for g in range(8)]
    assert sorted(cols) == list(range(16))
    assert all(frag_col(2 * q + 1) - frag_col(2 * q) == 4 for q in range(4))


@pytest.mark.parametrize("shape", [(1, 64, 7, 5), (3, 64, 33, 17),
                                   (1, 64, 1, 1), (2, 64, 10, 13),
                                   (1, 64, 8, 16), (1, 64, 160, 160)])
def test_conv_split_holds_the_fp32_gate(shape):
    """Maps smaller than a tile, tiles ragged in both directions, one
    exact tile and the serving map at B = 1."""
    x, w, s, b = conv_inputs(shape, seed=shape[2])
    torch.testing.assert_close(emulate_conv(x, w, s, b),
                               conv3x3_bn_silu_reference(x, w, s, b),
                               **CONV_TOL)


def test_conv_split_matches_pallas_interpret():
    """The JAX kernel at tests/test_torch_port_conv.py's small shape: it
    keeps the folded weights w * s in bf16, so the emulation gets those
    weights divided by s, as that test's plain version does; 1e-4."""
    B, H, W, C = 1, 16, 12, 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, C, C)).astype(np.float32) * 0.1
    s = rng.standard_normal(C).astype(np.float32) * 0.5 + 1.0
    b = rng.standard_normal(C).astype(np.float32) * 0.1
    w6, bias2 = pack_weights(w, s, b)
    want = np.asarray(packed_conv3x3_silu(jnp.asarray(x), w6, bias2,
                                          interpret=True))
    wf = np.asarray((w * s).astype(jnp.bfloat16), np.float32) / s   # HWIO
    got = emulate_conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                       torch.from_numpy(wf.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)


# ---- why the split ----------------------------------------------------------

def test_tf32_rounding_and_the_split():
    """Ties round away from zero in both signs; big + small gives x back
    to about 2^-22 relative."""
    one = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                        1 + 3 * 2 ** -11])
    assert tf32(one).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                                  1 + 2 ** -9]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=10000).astype(np.float32))
    big, small = split(x)
    assert (tf32(big) == big).all() and (tf32(small) == small).all()
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((big - x).abs() > x.abs() * 2.0 ** -14).any()


def test_a_single_tf32_pass_fails_the_fp32_gates():
    """One TF32 product (big_a big_b) in place of the three, at the
    flagship's shapes at B = 1 and the serving conv map: each fails its
    fp32 gate, which the split holds (the tests above)."""
    for N, D in ATTN_SHAPES:
        args = attention_inputs(1, N, D, seed=N)
        with pytest.raises(AssertionError):
            assert_attention_close(args, passes=1)
    x, w, s, b = conv_inputs((1, 64, 160, 160), seed=160)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(emulate_conv(x, w, s, b, passes=1),
                                   conv3x3_bn_silu_reference(x, w, s, b),
                                   **CONV_TOL)
