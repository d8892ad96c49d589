"""Gradual magnitude pruning and SNIP training in the port against the JAX
package on danube SMOKE (f32, kernel='masked', flash_tight): from the
reference's state carried across by the bridge, the prune event's and the
SNIP init's masks element for element and the steps around them within
the stated tolerance.  The shared helpers live in test_torch_methods.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import pruning as j_pruning  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.training import init_train_state, make_prune_fn, snip_init  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from test_torch_methods import (  # noqa: E402
    ADAM,
    LR,
    _batch,
    _bridge,
    _cfgs,
    _close_trees,
    _np,
    _train_steps,
)


def test_pruning_trajectory_matches_jax():
    """Dense start (all-ones masks) under kernel='masked', two steps, a
    prune event to the ramp's target at the state's step, a third step:
    masks equal element for element, params and Adam state within TOL."""
    jcfg, tcfg = _cfgs("pruning")
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig(**ADAM))
    tst = _bridge(st)
    assert all(bool(m.all()) for m in tree_paths(tst["masks"]).values())
    assert "pack" not in tst and "bwd_masks" not in tst
    st, tst = _train_steps(jcfg, tcfg, st, tst, (0, 1), ADAM, LR)
    kw = dict(final_sparsity=0.8, begin_step=0, end_step=4, prune_every=2)
    st = jax.jit(make_prune_fn(jcfg, j_pruning.PruningSchedule(**kw)))(st)
    sched = t_pruning.PruningSchedule(**kw)
    tst = tsteps.refresh_pack(tsteps.make_prune_fn(tcfg, sched)(tst), tcfg)
    s_t = float(sched.target(2))
    want = _np(st["masks"])
    for n, m in tree_paths(tst["masks"]).items():
        np.testing.assert_array_equal(m.numpy(), want[n], err_msg=n)
        assert int(m.sum()) == int(np.round(np.float32(1 - s_t) * m.numel()))
    _close_trees(tst["params"], st["params"], "pruned params")
    _train_steps(jcfg, tcfg, st, tst, (2,), ADAM, LR)


def test_snip_trajectory_matches_jax():
    """SNIP's masks from step 0's batch under kernel='masked', element for
    element the reference's and at the ERK map's per-layer density, then
    two train steps within TOL."""
    jcfg, tcfg = _cfgs("snip")
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig(**ADAM))
    tst = _bridge(st)
    jb, tb = _batch(jcfg, 0)
    st = snip_init(st, jcfg, jb)
    tst = tsteps.refresh_pack(tsteps.snip_init(tst, tcfg, tb), tcfg)
    want = _np(st["masks"])
    flags = tree_map(lambda _, m: m is not None, tst["masks"])
    smap = tsteps.sparsity_map(tcfg, tst["params"], flags)
    for n, m in tree_paths(tst["masks"]).items():
        np.testing.assert_array_equal(m.numpy(), want[n], err_msg=n)
        assert int(m.sum()) == round((1 - smap[n]) * m.numel())
    _close_trees(tst["params"], st["params"], "snip params")
    _train_steps(jcfg, tcfg, st, tst, (0, 1), ADAM, LR)
