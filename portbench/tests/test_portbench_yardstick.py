"""The yardstick's operation, byte and least-time arithmetic against
values worked out by hand."""


import pytest
import torch

from portbench.core import yardstick as Y


def test_peaks_and_rate():
    assert Y.PEAK_OPS == {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
                          "3xtf32": 165e12}
    assert Y.HBM_BYTES_PER_S == 3.35e12


def test_least_time_takes_the_larger_bound():
    assert Y.least_s(989e12, 0, "bf16") == (1.0, "operations")
    assert Y.least_s(0, 3.35e12, "bf16") == (1.0, "bytes")
    t, what = Y.least_s(1979e9, 6.7e9, "int8")      # 1 ms vs 2 ms
    assert what == "bytes" and t == pytest.approx(2e-3)


def test_conv3x3_at_the_serving_shape():
    # (32, 64, 160, 160) bf16: 2*32*160*160*64*64*9 = 60.40 GFLOP (61.07 us
    # at 989 T/s); x and y 2 * 32*64*160*160 * 2 B = 209.7 MB, w 73.7 KB,
    # scale and bias 512 B: 62.62 us at 3.35 TB/s, so the bytes bound it
    ops, nbytes = Y.conv3x3_work(32, 64, 160, 160, "bf16")
    assert ops == 60_397_977_600
    assert nbytes == 209_715_200 + 73_728 + 512
    t, what = Y.least_s(ops, nbytes, "bf16")
    assert what == "bytes" and t * 1e3 == pytest.approx(0.06262, abs=1e-5)


def test_int8_conv_at_the_serving_shape():
    # 3x3 64 -> 64 at (32, 64, 160, 160), bf16 in and out: the same MACs at
    # int8's 1979 T/s (30.5 us); bytes: 209.7 MB of maps, 36 864 B of int8
    # weights, 6 * 64 * 4 + 64 * 4 B of vectors: 62.61 us
    ops, nbytes = Y.conv_int8_work(32, 64, 160, 160, 64, 3, 160, 160, 1,
                                   "bf16")
    assert ops == 60_397_977_600
    assert nbytes == 209_715_200 + 36_864 + 1_536 + 256
    t, what = Y.least_s(ops, nbytes, "int8")
    assert what == "bytes" and t * 1e3 == pytest.approx(0.06261, abs=1e-5)


def test_attention_module_at_p5():
    # B 32, N 100 tokens, D 1024, bf16: 16*32*100*1024^2 + 8*32*100^2*1024
    # = 56.29 G; bytes 4*32*100*1024*2 + 8*1024^2*2 + 8*1024*2 + 4*1024*4
    ops, nbytes = Y.attention_work(32, 100, 1024, "bf16")
    assert ops == 53_687_091_200 + 2_621_440_000
    assert nbytes == 26_214_400 + 16_777_216 + 16_384 + 16_384
    t, what = Y.least_s(ops, nbytes, "bf16")
    assert what == "operations" and t == pytest.approx(ops / 989e12)


def test_flops_of_a_pair_on_the_reference_model():
    """FlopCounterMode on the plain reference, meta tensors: 192.5 GFLOP
    a yolov5l-Transfusion pair at 640, 109.2 M parameters."""
    from portbench.core import bench as B
    from portbench.reference import model as refm
    cfg = B.config("yolov5l-tfb-640-bf16")
    with torch.device("meta"):
        m = refm.Model(cfg["model"])
    assert sum(p.numel() for p in m.parameters()) == pytest.approx(109.2e6,
                                                                  rel=1e-3)
    mfu = B.reader("mfu.offline")
    per_pair = mfu.least_s_per_pair(cfg)
    assert per_pair == pytest.approx(192.518e9 / 989e12, rel=1e-4)
    # under W8A8 the quantized convs' operations go at int8's peak
    assert mfu.least_s_per_pair(B.config("yolov5l-tfb-640-int8")) < \
        0.6 * per_pair
