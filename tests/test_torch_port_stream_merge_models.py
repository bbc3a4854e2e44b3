"""Stream merging in the port on the other towers and on repeated rows,
against the JAX package's merged models (tests/test_stream_merge.py's
test_alt_backbone_merge and test_repeated_module_merge), on the CPU, from
the JAX models' own init; split from test_torch_port_stream_merge.py for
the test workers' balance. Tolerance rtol = atol = 1e-5, JAX's there."""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build
from icafusion_tpu.utils import stream_merge as jsm
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model, resolve_model
from icafusion_tpu_torch.utils import stream_merge as sm
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw

from test_torch_port_stream_merge import (TOL, _inputs, _jax_init, _jfwd,
                                          _with_rows)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["vgg16", "resnet50"])
def test_alt_backbone_merge(name):
    """VGGblock (conv + bias chains) and ResNetlayer (bottlenecks with
    per-channel residuals and the 7x7 stem) merge at k = 2 as in JAX: the
    merged port model against the JAX merged model, and unmerge gives the
    state back bit for bit."""
    mk = getattr(zoo, f"{name}_icafusion_config")
    jmk = getattr(jax_zoo, f"{name}_icafusion_config")
    cfg, jcfg = mk(nc=3), jmk(nc=3)
    rgb, ir = _inputs(1, 320)
    v = _jax_init(jcfg, rgb, ir)
    model = load_jax_variables(build_model(cfg), v)
    mv = jsm.merge_stream_variables(jcfg, v, pairs=2)
    want = np.asarray(_jfwd(jax_build(jcfg, merge_pairs=2))(
        mv, jnp.asarray(rgb), jnp.asarray(ir))[0])
    mm = sm.merged_model(model, 2)
    with torch.no_grad():
        got = mm(nchw(rgb), nchw(ir)).numpy()
        ref = model(nchw(rgb), nchw(ir)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    sd = model.state_dict()
    rt = sm.unmerge_stream_state(cfg, mm.state_dict(), 2)
    for k in sd:
        assert torch.equal(rt[k], sd[k]), k



def test_repeated_module_merge():
    """A repeated mergeable row ([-1, 2, 'Conv', [16, 3, 2]]) merges
    through the same Repeat wrapper as the main loop (r0, r1), as in JAX;
    128 px keeps P5 at the fusion grid after the extra stride-2 copy.
    JAX's own case repeats Conv(16, 32), whose second copy only flax can
    build (it infers a conv's input width; the port and the reference give
    every copy the row's c1), so the row here keeps its width."""
    rows = {i: {"n": 2, "args": (16, 3, 2)} for i in (1, 10)}
    cfg = _with_rows(zoo.tiny_icafusion_config(), rows)
    jcfg = _with_rows(jax_zoo.tiny_icafusion_config(), rows)
    assert resolve_model(cfg)[0][1].n == 2
    rgb, ir = _inputs(1, 128)
    v = _jax_init(jcfg, rgb, ir)
    mv = jsm.merge_stream_variables(jcfg, v, pairs=3)
    mm = load_jax_variables(build_model(cfg, merge_pairs=3), mv)
    assert hasattr(mm.m1_10, "r1")
    want = _jfwd(jax_build(jcfg, merge_pairs=3))(mv, jnp.asarray(rgb),
                                                  jnp.asarray(ir))[0]
    with torch.no_grad():
        got = mm(nchw(rgb), nchw(ir)).numpy()
        ref = load_jax_variables(build_model(cfg), v)(
            nchw(rgb), nchw(ir)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
