"""Hyperparameter evolution of the port (train/evolve.py) against the JAX
package's train/evolve.py: the same numpy Generator draws, so mutate,
select_parent and a whole evolve() give equal hyperparameters, as floats,
generation by generation. (cli.train --evolve is in
test_torch_port_fit.py.)"""

import dataclasses

import numpy as np
import pytest

from icafusion_tpu.config import HypConfig as JaxHyp
from icafusion_tpu.train import evolve as jev
from icafusion_tpu_torch.config import HypConfig
from icafusion_tpu_torch.train import evolve as ev


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_meta_and_mutate_match_jax():
    """The 27 META keys and bounds; ten mutations of one parent from one
    seed, and of a parent off the defaults, each equal as floats and
    inside its bounds."""
    assert ev.META == jev.META and len(ev.META) == 27
    for base, jbase in ((HypConfig(), JaxHyp()),
                        (HypConfig(lr0=0.02, mosaic=0.5, anchors=3.0),
                         JaxHyp(lr0=0.02, mosaic=0.5, anchors=3.0))):
        rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(10):
            got, want = ev.mutate(base, rng), jev.mutate(jbase, jrng)
            _same(got, want)
            for k, (_, lo, hi) in ev.META.items():
                assert lo <= getattr(got, k) <= hi, k
        assert got.anchors == base.anchors      # keys outside META stay


def test_select_parent_matches_jax_and_drops_the_keys_outside_meta(
        tmp_path):
    """From the same log both packages pick the same parent with the same
    draws. JAX rebuilds it from the 27 META columns alone, so
    label_smoothing and anchors fall back to their defaults; the port
    copies that (a JAX-side fault, pinned here)."""
    log, jlog = (cls(tmp_path / f"{n}.csv") for cls, n in
                 ((ev.EvolveLog, "a"), (jev.EvolveLog, "b")))
    rng = np.random.default_rng(0)
    assert log.select_parent(rng) is None
    base = HypConfig(label_smoothing=0.1, anchors=3.0)
    for i, fit in enumerate((0.3, 0.7, 0.1, 0.5, 0.9, 0.2)):
        cand = ev.mutate(base, np.random.default_rng(i))
        log.append(fit, cand)
        jlog.append(fit, JaxHyp(**dataclasses.asdict(cand)))
    assert log.path.read_text() == jlog.path.read_text()
    np.testing.assert_array_equal(log.load(), jlog.load())
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        got, want = log.select_parent(rng), jlog.select_parent(jrng)
        _same(got, want)
        assert (got.label_smoothing, got.anchors) == (0.0, 0.0)


def test_evolve_four_generations_matches_jax(tmp_path):
    """evolve() over 4 generations with a fixed fitness function of the
    candidate: the two logs are byte-equal and the best candidates equal
    as floats."""
    def fitness(h):
        return float(h.lr0 * 10 + h.mosaic - abs(h.momentum - 0.9))

    got = ev.evolve(fitness, HypConfig(), generations=4,
                    log_path=str(tmp_path / "port.csv"), seed=5)
    want = jev.evolve(fitness, JaxHyp(), generations=4,
                      log_path=str(tmp_path / "jax.csv"), seed=5)
    _same(got, want)
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.splitlines()) == 5


@pytest.mark.parametrize("seed", [0, 1])
def test_evolve_resumes_from_an_existing_log(tmp_path, seed):
    """A second evolve() on the same log picks its parents from the first
    run's rows, in both packages alike."""
    def fitness(h):
        return float(h.box + h.cls)

    for gens in (2, 3):
        got = ev.evolve(fitness, HypConfig(), generations=gens,
                        log_path=str(tmp_path / "p.csv"), seed=seed)
        want = jev.evolve(fitness, JaxHyp(), generations=gens,
                          log_path=str(tmp_path / "j.csv"), seed=seed)
        _same(got, want)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
