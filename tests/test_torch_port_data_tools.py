"""data/tools.py of the port against the JAX package's data/tools.py, on
two copies of one folder: a synthetic paired set (data/synthetic) with
the KAIST fixtures of tests/fixtures nested inside it, and an unlabelled
image. Each tool leaves both trees equal, byte for byte."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from icafusion_tpu.data import tools as jtools
from icafusion_tpu_torch.data import tools
from icafusion_tpu_torch.data.synthetic import make_dataset

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture
def twins(tmp_path):
    """Two equal copies of the folder: (port's root, JAX's root)."""
    src = tmp_path / "src"
    make_dataset(src, 8, np.random.default_rng(0), hw=(48, 64))
    nested = src / "extra" / "deeper"
    nested.mkdir(parents=True)
    for f in sorted(FIXTURES.glob("*.txt")):
        shutil.copy(f, nested / f.name)
    shutil.copy(src / "visible" / "train" / "i0000.jpg",
                src / "visible" / "train" / "unlabelled.jpg")
    roots = tmp_path / "port", tmp_path / "jax"
    for r in roots:
        shutil.copytree(src, r / "data")
    return roots


@pytest.mark.parametrize("weights,annotated", [((0.5, 0.3, 0.2), False),
                                               ((0.9, 0.1, 0.0), True)])
def test_autosplit_matches_jax(twins, weights, annotated):
    for root, mod in zip(twins, (tools, jtools)):
        mod.autosplit(str(root / "data" / "visible"), weights=weights,
                      annotated_only=annotated, seed=3)
    a, b = (_tree(r) for r in twins)
    assert a == b
    lists = [k for k in a if k.startswith("data/autosplit_")]
    assert lists and sum(a[k].count(b"\n") for k in lists) == 9 - annotated


def test_extract_boxes_matches_jax(twins):
    n = [mod.extract_boxes(str(root / "data" / "visible"))
         for root, mod in zip(twins, (tools, jtools))]
    assert n[0] == n[1] > 0
    a, b = (_tree(r) for r in twins)
    assert a == b
    assert sum(k.startswith("data/classifier/") for k in a) == n[0]


def test_flatten_recursive_matches_jax(twins):
    outs = [mod.flatten_recursive(str(root / "data"))
            for root, mod in zip(twins, (tools, jtools))]
    assert [o.name for o in outs] == ["data_flat", "data_flat"]
    a, b = (_tree(r) for r in twins)
    assert a == b
    assert "data_flat/MBNet_result.txt" in a
