#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (icafusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises, so the
exit code is non-zero and the final line is never printed:

0. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   which of msgpack, yaml, cv2, PIL, torchvision and matplotlib import;
1. the build of the CUDA kernels (one nvcc per source, in parallel) with the
   -Xptxas -v report;
2. the dual cross-attention kernel against its plain PyTorch version on the
   card, at the serving path's three shapes (at B = 4, and at the
   MicroBatcher's buckets 1 and 32), at the fusion levels of every other
   shipped config (B = 4; heads of 8 to 256 values) and five ragged
   lengths, float32 and bfloat16, timed beside the plain version and a
   library yardstick, each by device time (torch.profiler) and by CUDA
   events, the kernel's device time also by launch (the projections, the
   core), float32 beside its bound at the 3xTF32 rate and at FFMA's, and
   its launches held to the 3xTF32 kernels;
3. the greedy NMS kernels (suppression bitmask, then the walk) against the
   plain loop on the card, B = 4, at K = 1, 1024 (the serving pool), 4096,
   8193 and 20000, at B = 1 and 32 with K = 1024, at B = 8, K = 8192 (the
   Evaluator's shape), and with padding of 0, -0.5 and -2 in place of -1;
   ties present: keep and ok must be equal. Each case prints its time and
   kept count;
3b. the fused conv3x3 + BatchNorm + SiLU kernel (64 channels) against its
   plain version, at the serving path's shape (4, 64, 160, 160), at
   batches 1 and 32 of it, on a 512 x 640 canvas (16, 64, 128, 160), six
   ragged ones and the validation path's rect (2, 64, 68, 84) and TTA
   (2, 64, 56, 56) maps, float32 and bfloat16, channels_last (the serving
   path's layout) and NCHW (a .pt2 program's, Grad-CAM's and an
   ensemble's on ordinary tensors), timed like phase 2, each row held by
   profiler name to its route's kernel (kernels/packed_conv.py: route:
   nhwc, nchw_tma or nchw_ld), each NCHW row printed beside the first
   design's time (smoke/common.FIRST_DESIGN_NCHW_MS) and cuDNN's NCHW
   call;
4. the slice: (a) a tiny model served on the card against the same engine
   on the CPU; (b) ServingEngine on yolov5l-Transfusion at 640, batch 4,
   bfloat16, random weights from torch.Generator().manual_seed(0), three
   requests (full, ragged 3, full) with every kernel launch counted (six
   fused convs per forward);
   (c) steady throughput and device time by kernel (torch.profiler);
   (d) detection agreement of the bf16 and fp32 engines, printed only;
5. the trained yolov5n-Transfusion checkpoint (artifacts/trained_n320, read
   by the port's own reader) through the port's Evaluator on its 77 val
   pairs at 320, float32 and bfloat16: mAP@50 within 0.3 points of the
   reference stack's record in TRAINED_PARITY.json;
6. training: (a) three Trainer steps of a tiny model (64 px, batch 2,
   fp32, dropout off) on the card against the same steps on the CPU, and
   the max-pool gradients of SPPF and of the fusion block's pooling on tied
   integer data against the first-winner plain version; (b) the slice:
   yolov5l-Transfusion at 640, batch 8, bf16, SGD, on batches of the
   port's PairedLoader over 48 synthetic FLIR-geometry pairs (512 x 640):
   2 warm-up and 10 timed steps, step time, images/s, device busy, idle
   share and peak memory; (c) fit: yolov5n-Transfusion at 320 on the same
   pairs, 2 epochs of batch 16 in bf16 with the EMA evaluated after each,
   the three kernels launched there, the stripped checkpoint served;
7. validation: the trained yolov5s-Transfusion checkpoint
   (artifacts/trained_s640) on its 141 held-out extval pairs at 640,
   batch 16, each run with the three kernels' launches counted: (a)
   python -m icafusion_tpu_torch.cli.val in fp32 with the MR txts, the
   COCO json scored against ground truth built from the labels, and the
   confusion matrix; (b) the Evaluator in bf16; (c) cli.val --rect (one
   544 x 672 canvas); (d) cli.val --augment, and the TTA predictions of
   two pairs on the card against the port's CPU run. mAP@50 of (a), (b)
   and (c) within 0.3 points of the JAX package's records and the
   reference stack's in TRAINED_PARITY_640.json;
8. serving through the entry points a user calls, each run with the three
   kernels' launches counted and held to 3 attention, 1 NMS and 5 (s) or
   6 (l) conv launches a batch: (a) python -m icafusion_tpu_torch.cli.detect
   on trained s640 over the 141 extval pairs, fp32, batch 16, square and
   --rect (one 512 x 640 canvas): every txt row equal to
   ServingEngine.predict_arrays' on the same letterboxed pairs; (b)
   predict_paths on a 512 x 640 engine, pipelined equal to serial equal
   to predict_arrays on decode_letterbox_batch; (c) the MicroBatcher over
   yolov5l-Transfusion 640 in bf16 (phase 4b's weights), every bucket
   warmed, 96 extval pairs submitted from 24 threads, held to serial
   batch-1 predict_arrays, with the latency of a lone request and the
   time a pair at bucket 32; (d) the HTTP server over s640 on 512 x 640 in
   bf16 with a MicroBatcher, 16 clients POSTing the 141 pairs as base64
   JPEGs, held to predict_arrays, /v1/stats and a 400; (e)
   ServingEngine.throughput at l 640, batch 4, bf16, beside phase 4c;
10. every shipped model config: (a) yolov5l_NiNfusion, yolov5l_Add,
   yolov5x_Transfusion, yolov5_VGG16_Transfusion and
   yolov5_ResNet50_Transfusion at 640 with seeded He-uniform weights
   (seeded_model): fp32 decoded predictions at batch 1 and the fused maps
   on the card against the port on the CPU (1e-3), then three bf16
   requests of 4 through predict_arrays with the launches held to the
   modules' (attention once per TransformerFusionBlock, the conv once per
   64-channel 3x3 SiLU Conv), and the device ms of a request's forward and
   NMS; (b) all 21 configs/models/*.yaml and zoo:dmaf:n at 320, batch 1,
   bf16: finite predictions, one detection array, the same launch rule;
   (c) phase 6a's card-against-CPU Trainer check for the nin, add and
   dmaf zoo kinds and narrow VGG16 and ResNet50 configs, with the CPU's
   own drift under one-ulp input changes printed beside;
11. int8 W8A8 serving: (a) the int8 conv kernel against its plain version
   at every quantized shape class of yolov5l-Transfusion 640, the rect
   canvas's P3 and two yolov5x widths, at B = 1, 4 and 32, fp32 and bf16
   (and NCHW input at B = 4): int32 accumulators equal, outputs within
   1e-5 (fp32) and 3e-2 (bf16) of the largest, timed beside the bound,
   the plain version, a cuDNN bf16 conv and, for 1x1, torch._int_mm, with
   the path each class takes (kernels/conv_int8.py: plan); then the stem
   path's classes (yolov5l's stem, the merged stem of Cin 6, a stem on a
   ragged map) at B = 1, 4 and 32, fp32 and bf16, channels_last and NCHW,
   each checked and timed the same way;
   (b) the flagship engine (phase 4b's weights) quantized by
   ServingEngine.quantize on two seeded batches, three counted requests
   (162 int8 launches a forward, 3 attention, 1 NMS, 0 fused convs),
   every int8 conv of a forward held to the plain version on its own
   input, each class's input layout and path (the two stems on the stem
   path, every other conv on the tma path from a channels_last map, none
   on the first design's direct path: asserted), the summed time beside
   the first design's, the stems-on-the-first-design sum's and cuDNN's,
   and device busy beside the
   bf16 engine's; (c)
   cli.val --int8 on
   trained s640 (extval, fp32) within 0.3 mAP@50 points of the JAX int8
   record and of 7a, the same calibration served in bf16 (printed), and
   trained n320 within 0.3 points of its JAX int8 record; (d) the HTTP
   server --int8 calibrated on 16 extval pairs, then restarted from its
   <weights>.calib, its responses against predict_arrays;
12. data parallel (parallel/mesh.py) on the one card: (a) fit with
   distributed=True under torchrun's env:// contract over NCCL at world
   size 1 (NCCL refuses two ranks on one GPU), yolov5n-Transfusion at 320,
   one epoch, its losses against 6c's first epoch; (b) two gloo ranks that
   share cuda:0 (parallel/mesh.spawn), yolov5l-Transfusion at 640, fp32,
   global batch 8 = 2 x 4 (each image at its own brightness), three
   steps against one process on the 8 (losses, first-step gradients and
   state, each gated at ten times the one process's own one-ulp drift) and
   the state after them bit-equal across the ranks, then five bf16 steps
   with each step's time and its all-reduce time; (c) the Evaluator with two replicas on cuda:0 over
   trained n320, mAP@50 within the gate and within 1e-3 of phase 5, twice
   phase 5's launches; (d) ServingEngine(n_devices=2) of yolov5l 640 in
   bf16 at batch 8 and its quantized twin against two one-replica batch-4
   calls, 2 x 162 int8 launches a forward, and one request under
   torch.cuda.set_sync_debug_mode("warn"). (c) and (d) place both replicas
   on cuda:0 by patching mesh.cuda_devices;
13. reference weights (utils/torch_convert.py): (a) trained s640 written
   as a reference-named .pt by reverse_convert, read back bit-equal, then
   cli.val on it (fp32, batch 16) at phase 7a's mAP@50 to the printed
   digit and cli.detect's txts equal row for row to a .ckpt run, launches
   held to 3 attention, 1 NMS and 5 conv a batch; (b) the seeded
   yolov5l-Transfusion written as an fp16 {"ema", "model"} .pt (zeros
   under "model"), read by load_model_for_inference and served at 640,
   batch 4, bf16: detections bit-equal to an engine on the fp16-rounded
   weights in memory, 3/1/6 launches a batch; (c) the kitchen-sink graph
   of the 17 legacy YAML modules at 64 px, served on the card and on the
   CPU in fp32 (1e-3) and bf16 (matched detections), 1 NMS and no fused
   conv a batch, and a grouped 64 -> 64 3x3 Conv with no fused launch;
   (d) one epoch of fit on yolov5n-Transfusion at 320 from a
   single-stream .pt (model.0-9 of trained n320): the unused-key count and
   whether a TensorBoard writer came up;
14. export (cli/export.py, smoke/export.py), files in a temp dir: (a) the
   seeded yolov5l-Transfusion (phase 4b's weights) at 640, fp32, batch 1,
   as ONNX, run by the port's numpy evaluator and held to the port's
   forward on the card with cli.export --validate's gates, 3 attention
   and 6 fused conv launches, all 6 on the NCHW routes; (b) the same with --nms baked in, held to
   non_max_suppression on the card (1 NMS launch) at a threshold where no
   cap binds; (c) trained s640 calibrated on 16 extval pairs, exported as
   int8 QDQ ONNX: its scores within 0.05 of the card's int8 forward and
   of the fp32 graph, the int8 launches counted; (d) cli.export --include
   pt2 of the flagship on the card: 3 icafusion::dual_cross_attention and
   6 icafusion::conv3x3_bn_silu nodes, torch.export.load and a run within
   1e-5 of the eager forward, with the kernels launched (6 fused convs on
   the NCHW routes a forward) and the program's device ms a forward
   (queued_ms), then the same in bf16 with its detections matched
   (printed); (e) Grad-CAM on trained n320 at Detect's inputs and at layer
   4 (through the attention's and the fused conv's autograd paths), on a
   channels_last pair and on an NCHW one, card against CPU within 1e-3,
   the NCHW launches of each; (f)
   the kitchen-sink graph quantized (its depthwise Ghost convs on the
   int8 conv's grouped path) and a depthwise 64 -> 64 3x3 Conv: every
   grouped int8 conv's int32 accumulators equal the plain version's at
   B = 1, 4 and 32; then the depthwise 64 -> 64 3x3 and the four grouped
   classes of the CPU tests at (B, C, 160, 160), B = 1, 4 and 32:
   accumulators exact, each timed beside its bound, the plain version and
   cuDNN's bf16 grouped conv; (g) an ensemble of two seeded yolov5n
   members on the card, its candidates each member's own, its fused convs
   all on the NCHW routes;
15. stream merging, evolution and profiling (smoke/merge.py): (a) the
   flagship (phase 4b's weights) served at 640, batch 4, merged at 3
   pairs against unmerged, in fp32 with TF32 off (decoded predictions
   within 1e-3), bf16, int8 and int8 with fp32 float parts: detections at
   conf 0.25 matched both ways (>= 0.9 over all detections) but in int8
   with bf16, where every int8 conv of a merged forward is held exactly to
   its plain version and the match is printed beside the unmerged int8
   engine's against bf16 (the seeded model fills max_det, and any rounding
   change moves int8's ties there); each mode's device ms a request merged
   and unmerged and the launches of three counted requests; (b) trained n320 through cli.val
   --merge 7: fp32 mAP@50 within 1e-4 of the unmerged run, --int8 within
   0.3 points of the JAX int8 record; (c) three bf16 SGD steps of
   yolov5l-Transfusion 640, batch 8, merged at 3 pairs with the gradient
   mask against unmerged steps from the same weights: losses within 2e-2,
   the zero blocks exactly 0, the checkpoint written unmerged and loaded
   into an unmerged model, step times; (d) cli.train --evolve 2 --epochs
   1 at yolov5n 320 on phase 6c's pairs: evolve.csv and hyp_evolved.yaml;
   (e) model_info of yolov5l at 640 on the card equal to the CPU's,
   profile_layers' rows finite, a trace written and parsed.

The phase bodies live in icafusion_tpu_torch/smoke/ (one module a group
of phases); this script keeps the order, the names and the summary lines.
Before the last line it prints one JSON object with each kernel's launches
on the main path (phases 4b, 8, 10a, 12, 13a-13c, 14 and 15's merged
runs; the int8 conv's in 11b, 12d, 14c/14f and 15a/15b, its stem path's
and its grouped path's in the same runs; the fused conv's NCHW routes' in
14a/14b, 14d, 14e and 14g, fp32 and bf16 together and counted in the
fused conv's own entry as well, timed at (1, 64, 160, 160) fp32, a .pt2
forward's map), error,
device times (kernel, plain version and library yardstick, from
torch.profiler) and bound; the
last line is {"ok": true, "device": {...}}. Should the profiler record no
device time in two windows running, it is not used again in the run: later
device times come from calls queued behind a sleep kernel between CUDA
events (queued_ms), and the breakdowns by kernel print "not measured".
Exits non-zero without a CUDA device and outside a checkout of the
repository.
"""


from __future__ import annotations

import importlib.util
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--trained-l640"]):
        print("usage: chip_smoke.py [--trained-l640]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "icafusion_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention, dual_cross_attention_reference)
    from icafusion_tpu_torch.kernels.nms import greedy_nms, greedy_nms_reference
    from icafusion_tpu_torch.kernels.packed_conv import (
        conv3x3_bn_silu, conv3x3_bn_silu_reference)
    from icafusion_tpu_torch.kernels.packed_conv import route as conv_route
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import (icafusion_config,
                                                tiny_icafusion_config)
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    from icafusion_tpu_torch.smoke.common import (
        ATTN_RAGGED, ATTN_SHAPES, ATTN_SHIPPED, BATCH, BUCKETS,
        CONVS_PER_FORWARD, CONV_SHAPES, FIRST_DESIGN_NCHW_MS, HEADS,
        INT8_PATH_KEYS, MAP50_GATE, NCHW_KEY, PROFILER, STEADY_REQUESTS,
        TF32X3, attention_bound, attention_case, attention_library, both_ms,
        bound, bounds_text, check_pool_grads, conv_bound, conv_case,
        conv_library, cuda_ms, device_times, done, matched, nms_case, phase,
        profile_requests)
    from icafusion_tpu_torch.smoke.train import (
        fit_slice, train_card_vs_cpu, train_slice)
    from icafusion_tpu_torch.smoke.val import val_slice
    from icafusion_tpu_torch.smoke.int8 import int8_slice
    from icafusion_tpu_torch.smoke.serve import l640_slice, serve_slice
    from icafusion_tpu_torch.smoke.configs import (
        ALL_CONFIGS_SIZE, all_configs_slice, full_width_slice,
        train_families_card_vs_cpu)
    from icafusion_tpu_torch.smoke.parallel import parallel_slice
    from icafusion_tpu_torch.smoke.reference import reference_slice
    from icafusion_tpu_torch.smoke.export import export_slice
    from icafusion_tpu_torch.smoke.merge import merge_slice

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = phase("0 device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   {card}")
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} numpy {np.__version__}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("msgpack", "yaml", "cv2", "PIL", "torchvision",
                       "matplotlib")}
    print(f"   importable: {found}")
    done(t0)

    t0 = phase("1 build")
    b = _build.build()
    print(f"   {b.path.name}: nvcc {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers",
                                   "spill", "smem")):
            print(f"   {line.strip()}")
    _build.library()
    done(t0)

    if argv == ["--trained-l640"]:
        with tempfile.TemporaryDirectory() as tmp:
            l640_slice(Path(tmp))
        print(f"== total {time.perf_counter() - t_all:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    report = {}
    gen = torch.Generator().manual_seed(0)

    t0 = phase("2 dual cross-attention vs plain (B=4, 1 and 32, h=8; every "
               "shipped width at B=4)")
    # fp32: rtol 2e-4 / atol 2e-5, the tolerance of the JAX package's Pallas
    # test (tests/test_pallas_kernels.py:52). bf16: 3e-2 / 3e-2. The kernel
    # rounds q/k/v to bf16 where the plain version (the JAX einsum path,
    # nn/fusion.py:237-266) does (the product, then its sum with the bias)
    # and the probabilities before the P V product, but it sums in another
    # order and rounds the probabilities before their normalisation, not
    # after: a few bf16 ulps (2^-8) of O(1) values.
    tol = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
    main_path = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0, "max_abs_err": 0.0, "bound_by": set()}
    events = {"ms": 0.0, "library_ms": 0.0}
    per_bucket = {}        # (B, dtype) -> kernel, plain, library ms a
    # forward, the bound, and in fp32 the bound at 3xTF32
    by_launch = {}         # (B, dtype) -> projections, core ms a forward
    cases = ([(BATCH, N, D) for N, D in ATTN_SHAPES + ATTN_RAGGED
              + ATTN_SHIPPED]
             + [(B, N, D) for B in BUCKETS for N, D in ATTN_SHAPES])
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, D in cases:
            vis, ir, ws, bs = attention_case(B, N, D, dtype, gen)
            out = dual_cross_attention(vis, ir, ws, bs, HEADS)
            ref = dual_cross_attention_reference(vis, ir, ws, bs, HEADS)
            torch.cuda.synchronize()
            rtol, atol = tol[dtype]
            err = 0.0
            for o, r in zip(out, ref):
                torch.testing.assert_close(o.float(), r.float(), rtol=rtol,
                                           atol=atol)
                err = max(err, (o.float() - r.float()).abs().max().item())
            if (N, D) in ATTN_RAGGED:
                print(f"   {str(dtype)[6:]:8s} B={B:2d} N={N:3d} D={D:4d}: "
                      f"max_abs_err {err:.3g} (ragged, not timed)")
                continue
            fn = lambda: dual_cross_attention(vis, ir, ws, bs, HEADS)
            launches = device_times(fn)
            ms, ms_ev = sum(launches.values()), cuda_ms(fn)
            if dtype == torch.float32 and not PROFILER["dead"]:
                # the 3xTF32 kernels, not the first design's FFMA ones
                for k in ("projections_tf32_kernel", "attention_tf32_kernel"):
                    assert any(k in n for n in launches), launches
            plain, plain_ev = both_ms(lambda: dual_cross_attention_reference(
                vis, ir, ws, bs, HEADS))
            lib, lib_ev = both_ms(lambda: attention_library(vis, ir, ws, bs))
            bnd, by = attention_bound(B, N, D, dtype)
            print(f"   {str(dtype)[6:]:8s} B={B:2d} N={N:3d} D={D:4d}: "
                  f"max_abs_err {err:.3g}  device ms: kernel {ms:.4f} plain "
                  f"{plain:.4f} "
                  f"library {lib:.4f}; events ms: kernel {ms_ev:.4f} plain "
                  f"{plain_ev:.4f} library {lib_ev:.4f}; "
                  f"{bounds_text(attention_bound, B, N, D, dtype=dtype)}"
                  f"{'' if (N, D) in ATTN_SHAPES else ' (shipped)'}")
            if (N, D) not in ATTN_SHAPES:
                continue
            bnd3 = attention_bound(B, N, D, dtype, TF32X3)[0]
            acc = per_bucket.setdefault((B, dtype), [0.0] * 5)
            for i, v in enumerate((ms, plain, lib, bnd, bnd3)):
                acc[i] += v
            split = by_launch.setdefault((B, dtype), [0.0, 0.0])
            split[0] += sum(v for k, v in launches.items()
                            if "projections" in k)
            split[1] += sum(v for k, v in launches.items()
                            if "attention" in k and "projections" not in k)
            if dtype == torch.bfloat16 and B == BATCH:  # the engine's
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("library_ms", lib)):
                    main_path[k] += v
                events["ms"] += ms_ev
                events["library_ms"] += lib_ev
                main_path["max_abs_err"] = max(main_path["max_abs_err"], err)
                main_path["bound_by"].add(by)
    report["dual_cross_attention"] = main_path
    for (B, dtype), (k, p, l, b, b3) in sorted(per_bucket.items(),
                                               key=lambda kv: kv[0][0]):
        proj, core = by_launch[(B, dtype)]
        split = ("not measured" if PROFILER["dead"] else
                 f"projections {proj:.4f} ms, core {core:.4f} ms")
        bounds = (f"bound {b3:.5f} at 3xTF32, {b:.5f} at FFMA"
                  if dtype == torch.float32 else f"bound {b:.5f}")
        print(f"   B={B:2d} {str(dtype)[6:]:8s} per forward (3 calls), device "
              f"time: kernel {k:.4f} ms ({split}), plain {p:.4f}, library "
              f"{l:.4f}, {bounds}")
    print(f"   per forward (3 calls, bf16), device time: kernel "
          f"{main_path['ms']:.4f} ms, plain {main_path['plain_ms']:.4f} ms, "
          f"library {main_path['library_ms']:.4f} ms, bound "
          f"{main_path['bound_ms']:.5f} ms; events: kernel "
          f"{events['ms']:.4f} ms, library {events['library_ms']:.4f} ms")
    done(t0)

    t0 = phase("3 greedy NMS vs plain loop (max_det=300)")
    for B, K, pad in ((BATCH, 1, -1.0), (BATCH, 1024, -1.0),
                      (BUCKETS[0], 1024, -1.0), (BUCKETS[1], 1024, -1.0),
                      (BATCH, 4096, -1.0), (8, 8192, -1.0),
                      (BATCH, 8193, -1.0), (BATCH, 20000, -1.0),
                      (BATCH, 1024, 0.0), (BATCH, 1024, -0.5),
                      (BATCH, 1024, -2.0), (BATCH, 8193, -0.5)):
        boxes, scores = nms_case(B, K, gen, pad)
        keep, ok = greedy_nms(boxes, scores, 0.45, 300)
        rkeep, rok = greedy_nms_reference(boxes, scores, 0.45, 300)
        torch.cuda.synchronize()
        if not (torch.equal(keep, rkeep) and torch.equal(ok, rok)):
            bad = (keep != rkeep) | (ok != rok)
            raise AssertionError(f"NMS B={B} K={K} pad={pad}: "
                                 f"{int(bad.sum())} of {bad.numel()} slots "
                                 f"differ")
        by_kernel = device_times(lambda: greedy_nms(boxes, scores, 0.45, 300))
        ms = sum(by_kernel.values())
        ms_ev = cuda_ms(lambda: greedy_nms(boxes, scores, 0.45, 300))
        split = {k: f"{sum(v for n, v in by_kernel.items() if k in n):.4f}"
                 if not PROFILER["dead"] else "not measured"
                 for k in ("nms_mask_kernel", "nms_scan_kernel")}
        # per step and candidate of the argmax loop: 4 min/max, 2 sub,
        # 2 clamp, 2 mul, 2 add, 1 sub, 1 div, 1 compare = 15 operations
        bnd, by = bound(15 * B * K * 300, B * K * 20 + B * 300 * 5,
                        torch.float32)
        line = (f"   B={B} K={K:5d} pad={pad:4.1f}: keep/ok equal "
                f"({int(ok.sum())} kept)  device ms: kernels {ms:.4f} "
                f"(mask {split['nms_mask_kernel']}, walk "
                f"{split['nms_scan_kernel']})")
        if (B, K, pad) == (BATCH, 1024, -1.0):   # the serving path's top_k
            plain, plain_ev = both_ms(
                lambda: greedy_nms_reference(boxes, scores, 0.45, 300),
                iters=2, warmup=1)
            line += f" plain {plain:.3f} (events {plain_ev:.3f})"
            report["greedy_nms"] = {"ms": ms, "plain_ms": plain,
                                    "bound_ms": bnd, "library_ms": None,
                                    "max_abs_err": 0.0, "bound_by": {by}}
        print(f"{line}; events ms: kernels {ms_ev:.4f}; bound {bnd:.5f} ms "
              f"({by})")
    done(t0)

    t0 = phase("3b conv3x3 + BN + SiLU (64 ch) vs plain")
    # fp32: rtol/atol 1e-4, the tolerance of the JAX package's Pallas test
    # (tests/test_pallas_kernels.py:104); both sum 576 fp32 products exactly
    # formed, in different orders. bf16: both form the products of the same
    # bf16 values exactly and sum in fp32, then round once to bf16, so they
    # differ by at most about one bf16 ulp (2^-8 relative): 1e-2 / 1e-2.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
    layouts = {"NHWC": torch.channels_last, "NCHW": torch.contiguous_format}
    for dtype, shape, (lname, layout) in itertools.product(
            (torch.float32, torch.bfloat16), CONV_SHAPES, layouts.items()):
        x, w, sc, bi = conv_case(shape, dtype, layout, gen)
        route = conv_route(x)
        out = conv3x3_bn_silu(x, w, sc, bi)
        ref = conv3x3_bn_silu_reference(x, w, sc, bi)
        torch.cuda.synchronize()
        assert out.stride() == x.stride(), (out.stride(), x.stride())
        rtol, atol = tol[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        err = (out.float() - ref.float()).abs().max().item()
        w_f = (w.float() * sc[:, None, None, None]).to(dtype)
        b_f = bi.to(dtype)
        fn = lambda: conv3x3_bn_silu(x, w, sc, bi)
        by_kernel = device_times(fn)
        ms, ms_ev = sum(by_kernel.values()), cuda_ms(fn)
        if not PROFILER["dead"]:   # the route's kernel, by its name
            kname = (f"conv3x3_{'bf16' if dtype == torch.bfloat16 else 'tf32'}"
                     f"_{route}_kernel")
            assert any(kname in n for n in by_kernel), (kname, by_kernel)
        plain, plain_ev = both_ms(
            lambda: conv3x3_bn_silu_reference(x, w, sc, bi))
        lib, lib_ev = both_ms(lambda: conv_library(x, w_f, b_f))
        bnd, by = conv_bound(shape, dtype)
        first = (FIRST_DESIGN_NCHW_MS.get((dtype, shape))
                 if lname == "NCHW" else None)
        print(f"   {str(dtype)[6:]:8s} {lname} {str(shape):18s} {route:8s}: "
              f"max_abs_err {err:.3g} (rtol {rtol:g}, atol {atol:g})  device "
              f"ms: kernel {ms:.4f} plain {plain:.4f} library {lib:.4f}; "
              f"events ms: kernel {ms_ev:.4f} plain {plain_ev:.4f} library "
              f"{lib_ev:.4f}; {bounds_text(conv_bound, shape, dtype=dtype)}"
              + ("" if first is None else
                 f"; NCHW: kernel {ms:.4f} ms, first design "
                 f"{first:.4f}, cuDNN NCHW {lib:.4f}"))
        if (dtype == torch.bfloat16 and shape == CONV_SHAPES[0]
                and lname == "NHWC"):            # the serving path's
            report["conv3x3_bn_silu"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "library_ms": lib, "max_abs_err": err, "bound_by": {by}}
        if (dtype == torch.float32 and shape == CONV_SHAPES[1]
                and lname == "NCHW"):            # a .pt2 forward's, fp32 b1
            tf32_bnd, tf32_by = conv_bound(shape, dtype, TF32X3)
            report[NCHW_KEY] = {
                "ms": ms, "plain_ms": plain, "bound_ms": tf32_bnd,
                "library_ms": lib, "max_abs_err": err,
                "bound_by": {tf32_by}}
    done(t0)

    # the fp32 kernels' launches on the entry points' paths (phases 4-15)
    dual_cross_attention.tf32_launches = 0
    conv3x3_bn_silu.tf32_launches = 0
    conv3x3_bn_silu.nchw_launches = 0

    t0 = phase("4a tiny model: engine on the card vs on the CPU (fp32)")
    tiny = build_model(tiny_icafusion_config(),
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    ir = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    on = {d: ServingEngine(tiny, (64, 96), 4, conf_thres=0.25,
                           dtype="float32", device=d) for d in ("cuda", "cpu")}
    preds = {}
    for d, eng in on.items():
        with torch.inference_mode():
            x = torch.from_numpy(rgb).to(d).permute(0, 3, 1, 2).float() / 255
            y = torch.from_numpy(ir).to(d).permute(0, 3, 1, 2).float() / 255
            preds[d] = eng.model(x, y).cpu()
    torch.testing.assert_close(preds["cuda"], preds["cpu"], rtol=1e-3,
                               atol=1e-3)
    dets = {d: eng.predict_arrays(rgb, ir) for d, eng in on.items()}
    print(f"   decoded predictions allclose (rtol/atol 1e-3); detections "
          f"per image card {[len(x) for x in dets['cuda']]} cpu "
          f"{[len(x) for x in dets['cpu']]}")
    done(t0)

    t0 = phase("4b slice: yolov5l-Transfusion 640, batch 4, bf16")
    model = build_model(icafusion_config("l", nc=3, fusion="tfb"),
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, 640, BATCH, conf_thres=0.001,
                           dtype="bfloat16")
    rng = np.random.default_rng(1)
    pairs = [(rng.integers(0, 256, (n, 640, 640, 3), np.uint8),
              rng.integers(0, 256, (n, 640, 640, 3), np.uint8))
             for n in (BATCH, 3, BATCH)]
    engine.predict_arrays(*pairs[0])                  # warm-up
    torch.cuda.synchronize()
    dual_cross_attention.launches = 0
    greedy_nms.launches = 0
    conv3x3_bn_silu.launches = 0
    results, req_ms = [], []
    for rgb, ir in pairs:
        t = time.perf_counter()
        results.append(engine.predict_arrays(rgb, ir))
        req_ms.append(1e3 * (time.perf_counter() - t))
    launches = {"dual_cross_attention": dual_cross_attention.launches,
                "greedy_nms": greedy_nms.launches,
                "conv3x3_bn_silu": conv3x3_bn_silu.launches}
    print(f"   {n_params / 1e6:.1f} M parameters; launches {launches}; "
          f"fused convs per forward "
          f"{launches['conv3x3_bn_silu'] / len(pairs):g}")
    for (rgb, _), out, ms in zip(pairs, results, req_ms):
        print(f"   request of {len(rgb)}: {ms:.1f} ms, "
              f"{1e3 * len(rgb) / ms:.1f} pairs/s, detections per image "
              f"{[len(x) for x in out]}")
        assert len(out) == len(rgb)
        for x in out:
            assert x.ndim == 2 and x.shape[1] == 6 and len(x) <= 300, x.shape
            assert np.isfinite(x).all()
    assert launches["dual_cross_attention"] == 3 * len(pairs), launches
    assert launches["greedy_nms"] == len(pairs), launches
    assert (launches["conv3x3_bn_silu"]
            == CONVS_PER_FORWARD * len(pairs)), launches
    done(t0)

    t0 = phase("4c slice throughput and device time (yolov5l 640, b4, bf16)")
    steady = []
    for _ in range(STEADY_REQUESTS):
        t = time.perf_counter()
        engine.predict_arrays(*pairs[0])
        steady.append(1e3 * (time.perf_counter() - t))
    print(f"   {STEADY_REQUESTS} full-batch requests: median "
          f"{np.median(steady):.2f} ms, min {min(steady):.2f} ms -> "
          f"{1e3 * BATCH / np.median(steady):.1f} pairs/s (median)")
    profile_requests(engine, pairs[0], float(np.median(steady)))
    done(t0)

    t0 = phase("4d bf16 vs fp32 engine (not gated)")
    fp32 = ServingEngine(model, 640, BATCH, conf_thres=0.001, dtype="float32")
    ref = fp32.predict_arrays(*pairs[0])
    with torch.inference_mode():
        dec = {}
        for name, eng in (("bf16", engine), ("fp32", fp32)):
            x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                    / 255 for a in pairs[0])
            dec[name] = eng.model(x.to(eng.dtype), y.to(eng.dtype))
        d = (dec["bf16"] - dec["fp32"]).abs()
        q = lambda t: float(torch.quantile(t.flatten().float(), 0.99))
        print(f"   decoded predictions, 99th percentile of |bf16 - fp32|: "
              f"xy {q(d[..., :2]):.3f} px, wh {q(d[..., 2:4]):.3f} px, "
              f"obj {q(d[..., 4]):.4f}, cls {q(d[..., 5:]):.4f}")
    agree = [round(matched(a, r), 4) for a, r in zip(results[0], ref)]
    print(f"   bf16 vs fp32 engine (not gated): share of bf16 detections "
          f"with an fp32 detection of the same class at IoU > 0.5: {agree}")
    done(t0)

    t0 = phase("5 trained yolov5n-Transfusion (n320): Evaluator, 77 val pairs")
    ckpt = REPO / "artifacts" / "trained_n320"
    record = json.loads((REPO / "TRAINED_PARITY.json").read_text())
    ref_map50 = record["torch"]["map50"]     # the reference stack, CPU fp32
    n320 = load_jax_variables(
        build_model(icafusion_config("n", nc=3, fusion="tfb")),
        load_inference_variables(ckpt / "stripped.ckpt"))
    data = ckpt / "data"
    val = PairedDetectionDataset(str(data / "visible" / "val"),
                                 str(data / "infrared" / "val"), 320, nc=3)
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu)
    for dtype, tag in (("float32", "fp32"), ("bfloat16", "bf16")):
        ev = Evaluator(n320, nc=3, dtype=dtype)
        for fn in wrappers:
            fn.launches = 0
        r = ev.run(PairedLoader(val, 8).val_batches(), 320)
        counts = {fn.__name__: fn.launches for fn in wrappers}
        jax_rec = record["ours"][tag]["ref_scored"]
        print(f"   {tag}: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} P "
              f"{r['mp']:.5f} R {r['mr']:.5f} over {r['seen']} pairs; "
              f"reference stack {ref_map50:.5f} (delta "
              f"{100 * (r['map50'] - ref_map50):+.3f} pts), JAX {tag} record "
              f"{jax_rec['map50']:.5f} (delta "
              f"{100 * (r['map50'] - jax_rec['map50']):+.3f} pts); "
              f"{r['t_total_ms']:.2f} ms per image; launches {counts}")
        assert r["seen"] == record["n_images"], r["seen"]
        assert all(counts.values()), counts
        if tag == "fp32":
            p5 = (r, counts)
        # ACCURACY.md's gate is the reference stack's mAP@50; the JAX bf16
        # record is itself 0.436 points below it (one box ~ 0.65 points on
        # 152 labels), so bf16 is held to the gate and its JAX record only
        # printed; fp32 is also held to its JAX record.
        assert abs(r["map50"] - ref_map50) <= MAP50_GATE, (tag, r["map50"])
        if tag == "fp32":
            assert abs(r["map50"] - jax_rec["map50"]) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("6a train step: card vs CPU (tiny, 64 px, b2, fp32)")
    train_card_vs_cpu()
    check_pool_grads(gen)
    done(t0)

    # phase 12a trains on these pairs again, against 6c
    train_tmp = tempfile.TemporaryDirectory()
    tmp = train_tmp.name
    from icafusion_tpu_torch.data.synthetic import make_dataset
    data_yaml = make_dataset(Path(tmp) / "data", 48,
                             np.random.default_rng(0), hw=(512, 640))
    t0 = phase("6b slice: training yolov5l-Transfusion 640, b8, bf16, SGD")
    train_slice(data_yaml, card)
    done(t0)
    t0 = phase("6c fit: yolov5n-Transfusion 320, 2 epochs, b16, bf16")
    fit_rows = fit_slice(data_yaml, Path(tmp) / "runs")
    done(t0)
    runs = Path(tmp) / "runs"

    with tempfile.TemporaryDirectory() as tmp:
        s640_fp32_map50 = val_slice(Path(tmp))

    with tempfile.TemporaryDirectory() as tmp:
        served = serve_slice(Path(tmp), model,
                             1e3 * BATCH / float(np.median(steady)), card)
    launches = {k: v + served[k] for k, v in launches.items()}
    del model, engine, fp32
    torch.cuda.empty_cache()

    full = full_width_slice(card)
    launches = {k: v + full[k] for k, v in launches.items()}
    t0 = phase(f"10b every shipped config and zoo:dmaf:n at "
               f"{ALL_CONFIGS_SIZE}, b1, bf16")
    all_configs_slice()
    done(t0)
    t0 = phase("10c train steps card vs CPU: tiny nin, add, dmaf; narrow "
               "VGG16, ResNet50 (64 px, b2, fp32)")
    train_families_card_vs_cpu()
    done(t0)

    (report["conv_int8_bn_act"], report["conv_int8_bn_act (stem)"],
     int8) = int8_slice(card, s640_fp32_map50)
    for k in ("conv_int8_bn_act", *INT8_PATH_KEYS.values()):
        launches[k] = int8[k]

    par = parallel_slice(card, data_yaml, runs, fit_rows, n320, val, p5)
    launches = {k: v + par.get(k, 0) for k, v in launches.items()}

    with tempfile.TemporaryDirectory() as tmp:
        ref = reference_slice(card, s640_fp32_map50, data_yaml, runs,
                              Path(tmp))
    launches = {k: v + ref.get(k, 0) for k, v in launches.items()}

    with tempfile.TemporaryDirectory() as tmp:
        report["conv_int8_bn_act (grouped)"], exp = export_slice(card,
                                                                 Path(tmp))
    launches = {k: v + exp.get(k, 0) for k, v in launches.items()}
    launches[NCHW_KEY] = exp[NCHW_KEY]   # 14a/b, 14d, 14e and 14g
    assert launches[NCHW_KEY] > 0, launches

    with tempfile.TemporaryDirectory() as tmp:
        merged = merge_slice(card, data_yaml, Path(tmp))
    train_tmp.cleanup()
    for k in ("dual_cross_attention", "greedy_nms", "conv_int8_bn_act",
              "conv_int8_bn_act (stem)"):
        assert merged[k] > 0, merged
    launches = {k: v + merged.get(k, 0) for k, v in launches.items()}
    for k in INT8_PATH_KEYS.values():
        assert launches[k] > 0, launches

    kernels = []
    for name, src, tpu in (
            ("dual_cross_attention",
             "icafusion_tpu_torch/csrc/dual_cross_attention.cu",
             "icafusion_tpu/kernels/cross_attention.py:71"),
            ("greedy_nms", "icafusion_tpu_torch/csrc/greedy_nms.cu",
             "icafusion_tpu/kernels/nms.py:71"),
            ("conv3x3_bn_silu", "icafusion_tpu_torch/csrc/conv3x3_bn_silu.cu",
             "icafusion_tpu/kernels/packed_conv.py:120"),
            # its NCHW routes (a .pt2 program's, Grad-CAM's, an ensemble's)
            (NCHW_KEY, "icafusion_tpu_torch/csrc/conv3x3_bn_silu.cu",
             "icafusion_tpu/kernels/packed_conv.py:120"),
            # no Pallas kernel: XLA's int8 conv of Conv._int8_conv
            ("conv_int8_bn_act", "icafusion_tpu_torch/csrc/conv_int8.cu",
             "icafusion_tpu/nn/layers.py:172"),
            # its stem path (the same conv at Cin 3 and 6)
            ("conv_int8_bn_act (stem)",
             "icafusion_tpu_torch/csrc/conv_int8_small.cu",
             "icafusion_tpu/nn/layers.py:172"),
            # its grouped path (feature_group_count there)
            ("conv_int8_bn_act (grouped)",
             "icafusion_tpu_torch/csrc/conv_int8_small.cu",
             "icafusion_tpu/nn/layers.py:175")):
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "/".join(sorted(r["bound_by"])),
            "library_ms": r["library_ms"]})
    tf32 = {"dual_cross_attention": dual_cross_attention.tf32_launches,
            "conv3x3_bn_silu": conv3x3_bn_silu.tf32_launches}
    print(f"   fp32 launches on the 3xTF32 kernels in phases 4-15 (the "
          f"conv's in both layouts): {tf32}")
    assert all(tf32.values()), tf32
    print(f"== total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0



if __name__ == "__main__":
    sys.exit(main())
