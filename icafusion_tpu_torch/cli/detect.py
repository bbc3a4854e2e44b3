"""Paired detection CLI of the port, with the flags of the JAX package's
cli/detect.py (reference detect_twostream.py:19-236): two image folders
zipped, letterboxed, run through the two-stream model and NMS on the
device, drawn, saved and timed; or a pair of videos, or of live streams.

    python -m icafusion_tpu_torch.cli.detect --weights best.ckpt \\
        --cfg zoo:tfb:s --source1 visible/test --source2 infrared/test \\
        --save-dir runs/detect [--rect] [--save-txt] [--device cpu]

It runs on the CUDA card (--device cpu for the CPU). --merge K serves the
stream-merged graph (utils/stream_merge.py).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.ops.boxes import scale_coords_np
from icafusion_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from icafusion_tpu_torch.utils.plots import COLORS, plot_one_box, save_one_box

VIDEO_FORMATS = (".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm")


def _label(names, cls, conf, args) -> str:
    """Caption per the reference's hide-labels/hide-conf flags
    (detect_twostream.py:151-153)."""
    if args.hide_labels:
        return ""
    s = names[int(cls)]
    return s if args.hide_conf else f"{s} {conf:.2f}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser("icafusion-torch-detect")
    ap.add_argument("--weights", required=True)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--source1", required=True,
                    help="RGB folder/glob, video, camera index or stream URL")
    ap.add_argument("--source2", required=True, help="IR, as --source1")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--rect", action="store_true",
                    help="minimal-rectangle letterbox (datasets.py:1424): "
                         "canvas = scaled size rounded up to a stride "
                         "multiple, pairs batched by canvas shape")
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--save-dir", default="runs/detect/exp")
    ap.add_argument("--save-txt", action="store_true",
                    help="save per-image labels (normalized cls xc yc w h)")
    ap.add_argument("--save-conf", action="store_true",
                    help="append confidence to --save-txt lines")
    ap.add_argument("--save-crop", action="store_true",
                    help="save detection crops under save-dir/crops/<class>/")
    ap.add_argument("--classes", nargs="+", type=int, default=None,
                    help="keep only these class ids in NMS")
    ap.add_argument("--agnostic-nms", action="store_true",
                    help="class-agnostic NMS")
    ap.add_argument("--line-thickness", type=int, default=None,
                    help="box line thickness px (default: auto from size)")
    ap.add_argument("--hide-labels", action="store_true")
    ap.add_argument("--merge", default="0", metavar="K",
                    help="stream-merge the first K RGB/IR layer pairs "
                         "(block-diagonal kernels, the same outputs; "
                         "utils/stream_merge.py); 'auto' is 0 in the port")
    ap.add_argument("--hide-conf", action="store_true")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--nosave", action="store_true")
    ap.add_argument("--augment", action="store_true",
                    help="TTA multi-scale/flip ensemble (models/tta.py)")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stream mode: stop after N frames (0 = run forever)")
    ap.add_argument("--stream-fps", type=float, default=0.0,
                    help="stream mode: pace file-replay 'streams' at this "
                         "rate (real cameras pace themselves; 0 = no pacing)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    return ap.parse_args(argv)


def make_infer(model, args, device):
    """The inference closure shared by the image, video and stream branches:
    (B, H, W, 3) uint8 pairs -> Detections on the device (forward or TTA,
    decode, NMS at top_k 1024, as the JAX package's _make_infer). ``model``
    is the float32 model on ``device``."""
    from icafusion_tpu_torch.models.tta import tta_inference

    classes = tuple(args.classes) if args.classes else None

    @torch.inference_mode()
    def infer(rgb: np.ndarray, ir: np.ndarray):
        x, y = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                .permute(0, 3, 1, 2).float() / 255.0 for a in (rgb, ir))
        pred = tta_inference(model, x, y) if args.augment else model(x, y)
        return non_max_suppression(
            pred, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            top_k=1024, agnostic=args.agnostic_nms, classes=classes)

    return infer


def _annotate_bgr(im0_rgb, pred, names, args):
    """RGB frame + detections -> BGR frame with drawn boxes (for cv2 IO)."""
    frame = im0_rgb[:, :, ::-1].copy()
    for x1, y1, x2, y2, conf, cls in pred:
        plot_one_box(frame, (x1, y1, x2, y2), _label(names, cls, conf, args),
                     COLORS[int(cls) % len(COLORS)],
                     line_thickness=args.line_thickness)
    return frame


def detect_videos(args, infer, names) -> int:
    """Paired-video inference (the reference's video branch through
    LoadImages, datasets.py:212-239): each frame pair served alone, the
    annotated frames written to <source1 stem>_det.mp4, the rate printed.
    Returns the number of frame pairs."""
    import cv2

    from icafusion_tpu_torch.data.streams import LoadPairedVideos

    S = args.img_size
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    src = LoadPairedVideos(args.source1, args.source2, img_size=S)
    writer = None
    n, t_total = 0, 0.0
    try:
        for rgb_l, ir_l, im0, _ in src:
            t0 = time.time()
            pred = detections_to_numpy(infer(rgb_l[None], ir_l[None]))[0]
            if n > 0:
                t_total += time.time() - t0
            h0, w0 = im0.shape[:2]
            if len(pred):
                pred[:, :4] = scale_coords_np((S, S), pred[:, :4], (h0, w0))
            frame = _annotate_bgr(im0, pred, names, args)
            if writer is None and not args.nosave:
                out_path = str(save_dir / (Path(args.source1).stem
                                           + "_det.mp4"))
                writer = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w0, h0))
            if writer is not None:
                writer.write(frame)
            n += 1
    finally:
        src.release()
        if writer is not None:
            writer.release()
    if writer is not None:
        print(f"video saved to {save_dir}")
    if n > 1:
        print(f"average: {(n - 1) / t_total:.1f} paired FPS")
    return n


def _is_stream(src: str) -> bool:
    """A camera index or a network stream URL (detect_twostream.py:51-54);
    both modalities are streams."""
    s = str(src)
    return s.isnumeric() or s.lower().startswith(("rtsp://", "rtmp://",
                                                  "http://", "https://"))


def detect_streams(args, infer, names, stale_timeout: float = 30.0) -> int:
    """Live paired-stream inference (LoadStreams, datasets.py:310-388):
    threaded latest-frame readers, the annotated latest frame written as
    stream0_last.jpg, the rate printed. Each frame is served once (by its
    sequence number); with no new frame for stale_timeout seconds (the end
    of a file, a disconnect) the loop ends. Returns the frames served."""
    import cv2

    from icafusion_tpu_torch.data.streams import LoadPairedStreams

    S = args.img_size
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    src = LoadPairedStreams([args.source1], [args.source2], img_size=S,
                            fps=args.stream_fps)
    n, t_total, last_seq = 0, 0.0, 0
    t_last_new = time.time()
    try:
        while args.max_frames <= 0 or n < args.max_frames:
            if src.seq[0] == last_seq:
                if time.time() - t_last_new > stale_timeout:
                    print(f"stream stale for {stale_timeout:.0f}s "
                          "(EOF/disconnect) - stopping")
                    break
                time.sleep(0.005)
                continue
            t_last_new = time.time()
            frames = src.read()
            # the sequence number after read(): a frame published between
            # the check and read() is the one read, and is not served again
            last_seq = src.seq[0]
            rgb_l, ir_l, im0, _ = frames[0]
            t0 = time.time()
            pred = detections_to_numpy(infer(rgb_l[None], ir_l[None]))[0]
            if n > 0:
                t_total += time.time() - t0
            h0, w0 = im0.shape[:2]
            if len(pred):
                pred[:, :4] = scale_coords_np((S, S), pred[:, :4], (h0, w0))
            if not args.nosave:
                cv2.imwrite(str(save_dir / "stream0_last.jpg"),
                            _annotate_bgr(im0, pred, names, args))
            n += 1
    finally:
        src.close()
    if n > 1:
        print(f"stream: {n} frames, average {(n - 1) / t_total:.1f} "
              "paired FPS")
    return n


def _emit_image(args, save_dir, names, stem, origs, pred, shape_info, canvas):
    """Per-image outputs of the square and rect folder paths: boxes scaled
    to native coordinates, --save-txt labels (detect_twostream.py:145-148),
    --save-crop crops, annotated jpgs."""
    import cv2

    im0, im1 = origs
    (h0, w0), ratio_pad = shape_info
    if len(pred):
        pred[:, :4] = scale_coords_np(canvas, pred[:, :4], (h0, w0),
                                      ratio_pad=ratio_pad)
    if args.save_txt and len(pred):
        lines = []
        for x1, y1, x2, y2, s, c in pred:
            xc, yc = (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0
            bw, bh = (x2 - x1) / w0, (y2 - y1) / h0
            row = f"{int(c)} {xc:g} {yc:g} {bw:g} {bh:g}"
            lines.append(row + (f" {s:g}" if args.save_conf else ""))
        (save_dir / f"{stem}.txt").write_text("\n".join(lines) + "\n")
    if args.save_crop:
        for x1, y1, x2, y2, conf, cls in pred:
            save_one_box((x1, y1, x2, y2), im0,
                         save_dir / "crops" / names[int(cls)] / f"{stem}.jpg")
    if not args.nosave:
        for x1, y1, x2, y2, conf, cls in pred:
            label = _label(names, cls, conf, args)
            color = COLORS[int(cls) % len(COLORS)]
            plot_one_box(im0, (x1, y1, x2, y2), label, color,
                         line_thickness=args.line_thickness)
            plot_one_box(im1, (x1, y1, x2, y2), label, color,
                         line_thickness=args.line_thickness)
        cv2.imwrite(str(save_dir / f"{stem}_rgb.jpg"), im0)
        cv2.imwrite(str(save_dir / f"{stem}_ir.jpg"), im1)
    print(f"{stem}: {len(pred)} detections")


def _read_pair(f1, f2):
    """(BGR images of both files, RGB copies); raises on a file that does
    not decode."""
    import cv2
    ims = []
    for f in (f1, f2):
        im = cv2.imread(f)
        if im is None:
            raise OSError(f"cannot read image {f}")
        ims.append(im)
    return ims, [cv2.cvtColor(im, cv2.COLOR_BGR2RGB) for im in ims]


def detect_folder_rect(args, infer, names, files1, files2):
    """Minimal-rectangle folder inference (the reference's letterbox
    auto=True, datasets.py:1424): each pair letterboxes to its scaled size
    rounded up to a stride-32 multiple, and pairs are batched by canvas
    shape (a bucket is flushed when full, the rest at the end)."""
    from icafusion_tpu_torch.data.augment import letterbox

    S, B = args.img_size, args.batch_size
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    buckets = {}  # canvas -> [(stem, im0, im1, rgb_l, ir_l, shape_info)]
    seen = set()
    n_done, t_total = 0, 0.0

    def flush(canvas, items):
        nonlocal n_done, t_total
        count = len(items)
        items = items + [items[-1]] * (B - count)
        t0 = time.time()
        det_list = detections_to_numpy(infer(
            np.stack([it[3] for it in items]),
            np.stack([it[4] for it in items])))
        if canvas in seen:   # the first batch of a shape warms it up
            t_total += time.time() - t0
            n_done += count
        seen.add(canvas)
        for slot in range(count):
            stem, im0, im1, _, _, shape_info = items[slot]
            _emit_image(args, save_dir, names, stem, (im0, im1),
                        det_list[slot], shape_info, canvas)

    for f1, f2 in zip(files1, files2):
        (im0, im1), (rgb, ir) = _read_pair(f1, f2)
        rgb_l, ratio, pad = letterbox(rgb, S, scaleup=False, auto=True)
        ir_l = letterbox(ir, S, scaleup=False, auto=True)[0]
        canvas = rgb_l.shape[:2]
        buckets.setdefault(canvas, []).append(
            (Path(f1).stem, im0, im1, rgb_l, ir_l,
             (im0.shape[:2], (ratio, pad))))
        if len(buckets[canvas]) == B:
            flush(canvas, buckets.pop(canvas))
    for canvas, items in buckets.items():
        flush(canvas, items)
    if n_done:
        print(f"average: {n_done / t_total:.1f} paired FPS "
              f"({t_total / n_done * 1e3:.1f} ms/pair incl. host IO, "
              f"{len(seen)} canvas shape(s))")
    print(f"results saved to {save_dir}")


def detect_folder(args, infer, names, files1, files2):
    """Square-canvas folder inference in batches of --batch-size, the last
    batch padded with copies of its last pair."""
    from icafusion_tpu_torch.data.augment import letterbox

    S, B = args.img_size, args.batch_size
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    n_done, t_total = 0, 0.0
    for start in range(0, len(files1), B):
        idx = list(range(start, min(start + B, len(files1))))
        count = len(idx)
        idx += [idx[-1]] * (B - count)
        rgb_b = np.zeros((B, S, S, 3), np.uint8)
        ir_b = np.zeros((B, S, S, 3), np.uint8)
        origs, shapes = [], []
        for slot, i in enumerate(idx):
            (im0, im1), (rgb, ir) = _read_pair(files1[i], files2[i])
            origs.append((im0, im1))
            rgb_b[slot], ratio, pad = letterbox(rgb, S, scaleup=False)
            ir_b[slot] = letterbox(ir, S, scaleup=False)[0]
            # the letterbox's own ratio and pad: scaleup=False clamps r to
            # 1, which scale_coords_np cannot re-derive for small images
            shapes.append((im0.shape[:2], (ratio, pad)))
        t0 = time.time()
        det_list = detections_to_numpy(infer(rgb_b, ir_b))
        if start > 0:   # the first batch warms up
            t_total += time.time() - t0
            n_done += count
        for slot in range(count):
            _emit_image(args, save_dir, names, Path(files1[idx[slot]]).stem,
                        origs[slot], det_list[slot], shapes[slot], (S, S))
    if n_done:
        print(f"average: {n_done / t_total:.1f} paired FPS "
              f"({t_total / n_done * 1e3:.1f} ms/pair incl. host IO)")
    print(f"results saved to {save_dir}")


def main(argv=None):
    args = parse_args(argv)
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.datasets import discover_images
    from icafusion_tpu_torch.utils.general import resolve_device

    device = resolve_device(args.device, "cli.detect")
    mc, model = load_model_for_inference(args.cfg, args.weights,
                                         merge=args.merge)
    model = model.to(device)
    infer = make_infer(model, args, device)
    names = args.names or [str(i) for i in range(mc.nc)]
    if _is_stream(args.source1):
        return detect_streams(args, infer, names)
    if str(args.source1).lower().endswith(VIDEO_FORMATS):
        return detect_videos(args, infer, names)
    files1 = discover_images(args.source1)
    files2 = discover_images(args.source2)
    if len(files1) != len(files2):
        raise ValueError(f"paired sources differ in count: {len(files1)} "
                         f"vs {len(files2)}")
    if args.rect:
        return detect_folder_rect(args, infer, names, files1, files2)
    return detect_folder(args, infer, names, files1, files2)


if __name__ == "__main__":
    main()
