"""SNFS and Top-KAST training in the port against the JAX package on danube
SMOKE (f32, block-sparse kernels, flash_tight): two train steps and the
drop/grow at step 2 from the reference's state carried across by the
bridge, then the port's own superset refresh checked by its invariants.
The shared helpers live in test_torch_methods.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import init_train_state, make_algo, make_rigl_step  # noqa: E402
from repro_torch.core.masks import block_mask_of, tree_paths  # noqa: E402
from repro_torch.core.pack import pack_mismatch, validate_pack  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from test_torch_methods import (  # noqa: E402
    BLOCK,
    LR,
    SGD_WD,
    _batch,
    _bridge,
    _cfgs,
    _close,
    _close_trees,
    _np,
    _train_steps,
)


@pytest.mark.parametrize("method,opt_kw", [("snfs", SGD_WD), ("topkast", SGD_WD)])
def test_update_trajectory_matches_jax(method, opt_kw):
    """Two train steps then the drop/grow at step 2, from the reference's
    state: losses, params, optimizer state (and snfs's dense momentum)
    within TOL each step, the update's masks block for block; then the
    port's refresh: B ⊇ A, the pack fresh, snfs's momentum zero outside B,
    topkast's weights exactly zero outside B.  SGD with weight decay: over
    B for topkast; snfs's momentum takes the gradient before the decay."""
    jcfg, tcfg = _cfgs(method)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig(**opt_kw))
    tst = _bridge(st)
    assert ("dense_mom" in tst) == (method == "snfs")
    st, tst = _train_steps(jcfg, tcfg, st, tst, (0, 1), opt_kw, LR)
    jb, tb = _batch(jcfg, 2)
    st, jm = jax.jit(make_rigl_step(jcfg, make_algo(jcfg, 8), LRSchedule(**LR)))(st, jb)
    before = {n: m.clone() for n, m in tree_paths(tst["masks"]).items()}
    tst, tm = tsteps.make_rigl_step(tcfg, tsteps.make_algo(tcfg, 8), TLR(**LR))(tst, tb)
    _close(tm["loss"], jm["loss"], "update-step loss")
    want = _np(st["masks"])
    moved = 0
    for n, m in tree_paths(tst["masks"]).items():
        np.testing.assert_array_equal(block_mask_of(m, (BLOCK, BLOCK)).numpy(),
                                      np.asarray(block_mask_of(want[n], (BLOCK, BLOCK))),
                                      err_msg=n)
        assert int(m.sum()) == int(before[n].sum())
        moved += int((m & ~before[n]).sum())
    assert moved or method == "topkast"
    _close_trees(tst["params"], st["params"], "update-step params")
    tst = tsteps.refresh_pack(tst, tcfg)
    assert validate_pack(tst["pack"]) == 14
    assert int(pack_mismatch(tst["masks"], tst["pack"], (BLOCK, BLOCK),
                             bwd_masks=tst["bwd_masks"])) == 0
    bwd, params = tree_paths(tst["bwd_masks"]), tree_paths(tst["params"])
    for n, m in tree_paths(tst["masks"]).items():
        assert not (m & ~bwd[n]).any(), n
        if method == "topkast":
            assert (params[n][~bwd[n]] == 0).all(), n
        else:
            assert (tree_paths(tst["dense_mom"])[n][~bwd[n]] == 0).all(), n
