"""TTA on the trained yolov5s-Transfusion checkpoint (artifacts/trained_s640)
over its 141 held-out extval pairs at 640: the JAX package's cli.val
--augment and the port's, both in fp32 on the CPU, score mAP@50 within the
repo's 0.3-point gate (ACCURACY.md). It settles whether TTA scoring below
the plain forward on this set is the model's doing or the port's.

Slow: three to four minutes for the two runs on four CPU threads.

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \\
        tests/test_torch_port_tta_s640.py
"""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
S640 = ROOT / "artifacts" / "trained_s640"
MAP50_GATE = 0.003


@pytest.mark.slow
def test_tta_on_s640_extval_matches_jax(tmp_path):
    from icafusion_tpu.cli import val as jax_val
    from icafusion_tpu_torch.cli import val

    torch.set_num_threads(4)
    data = tmp_path / "extval.yaml"
    data.write_text(f"path: {S640 / 'extval'}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    args = ["--weights", str(S640 / "stripped.ckpt"), "--cfg",
            "yolov5s_Transfusion.yaml", "--data", str(data), "--img-size",
            "640", "--batch-size", "4", "--augment"]
    want = jax_val.main(args + ["--save-dir", str(tmp_path / "jax")])
    got = val.main(args + ["--save-dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    print(f"TTA mAP@50 on s640 extval: JAX {want['map50']:.5f}, port "
          f"{got['map50']:.5f} (both fp32 on the CPU); mAP JAX "
          f"{want['map']:.5f}, port {got['map']:.5f}")
    assert want["seen"] == got["seen"] == 141
    assert abs(got["map50"] - want["map50"]) <= MAP50_GATE
