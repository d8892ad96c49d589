"""Port host state vs the JAX package: ERK sparsities, PackState arrays,
AttnSchedules and the bridge, element by element on the smoke config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.attn_sched import sched_for as j_sched_for  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro.training.steps import sparsity_map as j_sparsity_map  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.attn_sched import sched_for  # noqa: E402
from repro_torch.core.distributions import sparsity_map  # noqa: E402
from repro_torch.core.masks import block_mask_of, tree_paths  # noqa: E402
from repro_torch.core.pack import (  # noqa: E402
    PackIntegrityError,
    build_pack_state,
    pack_entries,
    validate_pack,
)
from repro_torch.launch.serve import init_serving_state  # noqa: E402
from repro_torch.models.model import init_lm  # noqa: E402

BLOCK = 16
SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(BLOCK, BLOCK), kernel_block=(128, BLOCK, BLOCK))


@pytest.fixture(scope="module")
def jax_state():
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                              sparse=SparseConfig(**SPARSE))
    st, _, flags = init_train_state(jax.random.PRNGKey(0), cfg, OptConfig())
    return cfg, st, flags


def _jax_pack_flat(pack):
    flat, _ = jax.tree_util.tree_flatten_with_path(pack, is_leaf=is_pack_entry)
    return {path_name(p): {k: np.asarray(v) for k, v in e.items()}
            for p, e in flat if e is not None}


def _port_cfg():
    return dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**SPARSE))


def test_config_copy_matches_reference():
    """danube's and grok-1-314b's copies (the last config ported) equal the
    reference's field for field; a name neither package knows raises."""
    for arch in ("h2o-danube-1.8b", "grok-1-314b"):
        for smoke in (False, True):
            assert (dataclasses.asdict(t_get_config(arch, smoke=smoke))
                    == dataclasses.asdict(get_config(arch, smoke=smoke)))
    with pytest.raises(NotImplementedError, match="unknown architecture"):
        t_get_config("grok-2")


def _reference_shapes(cfg):
    """The reference's param shapes and sparse flags without allocating the
    weights: {path_name: shape struct}, {path_name: bool}."""
    box = {}

    def init(key):
        params, _, flags = j_init_lm(key, cfg)
        box["flags"] = flags
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return j_tree_paths(shapes), j_tree_paths(box["flags"])


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("dist", ["erk", "er", "uniform"])
def test_sparsity_map_matches_reference(smoke, dist):
    """The solver works from shapes and flags only, so the full-size config
    is checked on the reference's shapes (keyed by path_name, which a flat
    dict keeps); the smoke config also checks the port's own init_lm."""
    sp = dict(sparsity=0.8, distribution=dist)
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=smoke),
                               sparse=SparseConfig(**sp))
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=smoke),
                               sparse=TSparse(**sp))
    shapes, flags = _reference_shapes(jcfg)
    want = j_sparsity_map(jcfg, shapes, flags)
    got = sparsity_map(tcfg, shapes, flags)
    if smoke:
        got_own = sparsity_map(tcfg, *init_lm(tcfg, device="cpu"))
        assert got_own == got
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-12, abs=1e-12), name


def test_pack_state_matches_reference(jax_state):
    jcfg, st, _ = jax_state
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu"
    )
    masks = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu"
    )
    got = bridge.pack_flat_of(build_pack_state(masks, (BLOCK, BLOCK)))
    want = _jax_pack_flat(st["pack"])
    assert got.keys() == want.keys() and got
    for name, e in want.items():
        for k in ("idx", "cnt", "ridx", "rcnt", "nnz", "nkb"):
            np.testing.assert_array_equal(got[name][k], e[k], err_msg=f"{name}/{k}")


@pytest.mark.parametrize("args", [
    (64, 64, 16, 16, True, 16, 0),
    (128, 128, 128, 128, True, 0, 0),
    (300, 300, 128, 128, True, 4096, 0),
    (48, 48, 48, 48, True, 8, 0),
    (16, 40, 16, 48, True, 0, 24),
    (6144, 6144, 128, 128, True, 4096, 0),
])
def test_attn_schedule_matches_reference(args):
    got, want = sched_for(*args), j_sched_for(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_bridge_round_trips(jax_state):
    _, st, _ = jax_state
    flat_p = {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}
    flat_m = {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}
    flat_k = _jax_pack_flat(st["pack"])
    tp = bridge.params_from_flat(flat_p, "cpu")
    tm = bridge.masks_from_flat(flat_m, tp, "cpu")
    tk = bridge.pack_from_flat(flat_k, tp, "cpu")
    for got, want in ((bridge.flat_of(tp), flat_p), (bridge.flat_of(tm), flat_m)):
        assert got.keys() == want.keys()
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    back = bridge.pack_flat_of(tk)
    assert back.keys() == flat_k.keys()
    for n, e in back.items():
        # the reference's rigl state carries the Top-KAST superset view too
        assert set(e) == {"idx", "cnt", "ridx", "rcnt", "nnz", "nkb",
                          "bidx", "bcnt", "bnnz"}
        for k, v in e.items():
            np.testing.assert_array_equal(v, flat_k[n][k], err_msg=f"{n}/{k}")
    assert validate_pack(tk) == len(flat_k)


def test_init_serving_state_topology():
    """The port's own init: exact ERK block counts, zeros off the mask, a
    pack that describes the masks and passes its integrity check."""
    cfg = _port_cfg()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cpu")
    flat_p, flat_m = tree_paths(params), tree_paths(masks)
    smap = sparsity_map(cfg, *init_lm(cfg, device="cpu"))
    assert flat_m.keys() == smap.keys()
    for name, m in flat_m.items():
        bm = block_mask_of(m, (BLOCK, BLOCK))
        assert int(bm.sum()) == round((1 - smap[name]) * bm.numel()), name
        assert not flat_p[name][~m].any(), name
    entries = dict(pack_entries(pack))
    assert entries.keys() == flat_m.keys()
    assert validate_pack(pack) == len(entries)
    for name, e in entries.items():
        assert e["nnz"] == int(block_mask_of(flat_m[name], (BLOCK, BLOCK)).sum())


def test_validate_pack_rejects_truncation():
    cfg = _port_cfg()
    _, _, pack = init_serving_state(cfg, seed=0, device="cpu")
    e = pack["layers"][0]["mlp"]["wi"]["w"]
    e["cnt"] = e["cnt"].clone()
    e["cnt"][0] = e["idx"].shape[1] + 1
    with pytest.raises(PackIntegrityError, match="truncated|out of range"):
        validate_pack(pack)


def test_superset_pack_and_refresh_match_reference(jax_state):
    """The Top-KAST superset view: packing the reference's masks and
    backward supersets gives its bidx/bcnt/bnnz; a refresh after a layer
    loses blocks keeps every width (never shrink) as the reference's does;
    and validate_pack / pack_entry reject a superset that misses a forward
    block."""
    from repro.core.pack import refresh_pack_state as j_refresh

    from repro_torch.core.pack import pack_entry, refresh_pack_state

    _, st, _ = jax_state
    flat_m = {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}
    flat_b = {n: np.asarray(v) for n, v in j_tree_paths(st["bwd_masks"]).items()}
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    masks = bridge.masks_from_flat(flat_m, tp, "cpu")
    bwd = bridge.masks_from_flat(flat_b, tp, "cpu")
    keys = ("idx", "cnt", "ridx", "rcnt", "nnz", "nkb", "bidx", "bcnt", "bnnz")

    def same(got, want):
        assert got.keys() == want.keys() and got
        for name, e in want.items():
            for k in keys:
                np.testing.assert_array_equal(got[name][k], e[k], err_msg=f"{name}/{k}")

    pack = build_pack_state(masks, (BLOCK, BLOCK), bwd_masks=bwd)
    same(bridge.pack_flat_of(pack), _jax_pack_flat(st["pack"]))

    # layer 0's MLP input projection keeps only its first active block row
    name = "layers/0/mlp/wi/w"
    m = flat_m[name].copy()
    rows = np.flatnonzero(m.reshape(m.shape[0] // BLOCK, BLOCK, -1).any(axis=(1, 2)))
    m[(rows[0] + 1) * BLOCK:] = False
    j_masks = jax.tree_util.tree_map(lambda x: x, st["masks"])
    j_masks["layers"][0]["mlp"]["wi"]["w"] = m
    want = _jax_pack_flat(j_refresh(j_masks, (BLOCK, BLOCK), prev=st["pack"],
                                    bwd_masks=st["bwd_masks"]))
    t_masks = bridge.masks_from_flat(dict(flat_m, **{name: m}), tp, "cpu")
    got = refresh_pack_state(t_masks, (BLOCK, BLOCK), prev=pack, bwd_masks=bwd)
    same(bridge.pack_flat_of(got), want)
    e_old, e_new = dict(pack_entries(pack))[name], dict(pack_entries(got))[name]
    assert all(e_new[k].shape == e_old[k].shape for k in ("idx", "ridx", "bidx"))

    with pytest.raises(PackIntegrityError, match="contain"):
        pack_entry(flat_m[name], (BLOCK, BLOCK), bwd_mask=np.zeros_like(flat_m[name]))
    e = dict(pack_entries(pack))[name]
    j = int(np.flatnonzero(e["cnt"].numpy())[0])
    live = set(e["idx"][j, :int(e["cnt"][j])].tolist())
    outside = next(b for b in range(e["nkb"]) if b not in live
                   and b not in e["bidx"][j, :int(e["bcnt"][j])].tolist())
    s = int(np.flatnonzero(np.isin(e["bidx"][j].numpy(), list(live)))[0])
    e["bidx"] = e["bidx"].clone()
    e["bidx"][j, s] = outside
    with pytest.raises(PackIntegrityError, match="B does not contain A"):
        validate_pack(pack)
