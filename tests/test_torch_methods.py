"""The paper's baselines in the port against the JAX package: SET, SNFS and
Top-KAST drop/grow and DSR (masks bit for bit, on the reference's own
uniform draws handed in), gradual magnitude pruning and SNIP, the
Appendix H FLOP accounting, the topology distances and the train CLI.
The training trajectories from the reference's state are in
test_torch_methods_train.py (snfs, topkast) and test_torch_methods_prune.py
(pruning, snip), which share this file's helpers.

On the CPU the port's kernels run their plain versions and the JAX side its
Pallas kernels in interpret mode.  The port's own draws (supersets after a
refresh, the CLI's data) are torch's, not threefry: for those the tests
check invariants.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core import flops as j_flops  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro.core import rigl as j_rigl  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.core.schedules import UpdateSchedule as JSched  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import flops as t_flops  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core import rigl as t_rigl  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.core.distributions import LayerSpec as TLayerSpec  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.core.schedules import UpdateSchedule as TSched  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

J = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
T = lambda tree: tree_map(lambda _, a: None if a is None else torch.from_numpy(np.array(a)),
                          tree)


def _np(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


# ---------------------------------------------------------------------------
# drop/grow of set, snfs, topkast and DSR, on the reference's draws
# ---------------------------------------------------------------------------

SHAPES = {"a": (64, 96), "b": (48, 32)}


def _problem(rng, block, ties):
    """Two masked layers and a dense one.  Per layer: A, a superset B ⊇ A
    (B\\A partly trained, partly zero: the zeros tie and take Top-KAST's
    random tie-break), weights zero outside B, a dense gradient and a dense
    momentum.  ``ties`` draws magnitudes from three values, so the exact
    counts must break many ties as the reference does (lower flat index)."""
    draw = (lambda s: rng.integers(1, 4, s).astype(np.float32)) if ties else \
        (lambda s: rng.standard_normal(s).astype(np.float32))
    params, masks, bwd, grads, mom = {}, {}, {}, {}, {}
    for name, (K, N) in SHAPES.items():
        units = (K // 16, N // 16) if block else (K, N)
        a = rng.random(units) < 0.35
        b = a | (rng.random(units) < 0.25)
        trained = b & ~a & (rng.random(units) < 0.5)
        if block:
            up = lambda u: np.repeat(np.repeat(u, 16, 0), 16, 1)
            a, b, trained = up(a), up(b), up(trained)
        params[name] = {"w": draw((K, N)) * (a | trained)}
        masks[name], bwd[name] = {"w": a}, {"w": b}
        grads[name], mom[name] = {"w": draw((K, N))}, {"w": draw((K, N))}
    dense = rng.standard_normal((8, 8)).astype(np.float32)
    params["c"], grads["c"], mom["c"] = {"w": dense}, {"w": dense}, {"w": dense}
    masks["c"] = bwd["c"] = {"w": None}
    return params, masks, bwd, grads, mom


def _reference_draws(method, params, key, block):
    """The uniform draws the reference's rigl_update makes per layer:
    fold_in(key, i) over the params' leaf order; SET's of the weight's
    shape, Top-KAST's tie-break of the unit (block) shape."""
    out = {}
    for i, name in enumerate(sorted(params)):
        if name == "c":
            out[name] = {"w": None}
            continue
        shape = params[name]["w"].shape
        if method == "topkast" and block:
            shape = (shape[0] // 16, shape[1] // 16)
        out[name] = {"w": np.asarray(jax.random.uniform(jax.random.fold_in(key, i), shape))}
    return out


@pytest.mark.parametrize("method", ["set", "snfs", "topkast"])
@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_rigl_update_methods_match_jax(method, block, ties):
    """Masks, weights and grown flags element for element equal to the
    reference's, elementwise and in 16x16 blocks, with and without ties;
    counts kept; Top-KAST grows inside B and keeps its weights."""
    rng = np.random.default_rng(11 + 2 * block + ties + 7 * len(method))
    params, masks, bwd, grads, mom = _problem(rng, block, ties)
    kw = dict(method=method, block_shape=(16, 16) if block else None)
    jalgo = j_rigl.SparseAlgo(schedule=JSched(delta_t=100, t_end=1000, alpha=0.3), **kw)
    talgo = t_rigl.SparseAlgo(schedule=TSched(delta_t=100, t_end=1000, alpha=0.3), **kw)
    key = jax.random.PRNGKey(3)
    jp, jm, jg = j_rigl.rigl_update(J(params), J(masks), J(grads), jnp.int32(100), jalgo,
                                    key, dense_momentum=J(mom), bwd_masks=J(bwd))
    draws = _reference_draws(method, params, key, block)
    tp, tmk, tg = t_rigl.rigl_update(
        T(params), T(masks), T(grads), 100, talgo, dense_momentum=T(mom),
        bwd_masks=T(bwd), draws=None if method == "snfs" else T(draws))
    moved = 0
    for name in SHAPES:
        for got, want in ((tp, jp), (tmk, jm), (tg, jg)):
            np.testing.assert_array_equal(got[name]["w"].numpy(),
                                          np.asarray(want[name]["w"]), err_msg=name)
        new, old = tmk[name]["w"].numpy(), masks[name]["w"]
        assert new.sum() == old.sum()
        moved += int((new & ~old).sum())
        if method == "topkast":
            assert not (new & ~bwd[name]["w"]).any()
            assert tp[name]["w"] is not None
            np.testing.assert_array_equal(tp[name]["w"].numpy(), params[name]["w"])
    assert moved or ties or method == "topkast"
    assert tmk["c"]["w"] is None


def test_rigl_update_draws_from_the_generator_and_refuses_missing_state():
    """Without ``draws`` the port draws from its generator (reproducibly);
    snfs without the dense momentum and topkast without the supersets
    raise the reference's errors."""
    rng = np.random.default_rng(4)
    params, masks, bwd, grads, mom = _problem(rng, False, False)
    algo = lambda m: t_rigl.SparseAlgo(method=m, schedule=TSched(100, 1000, 0.3))
    runs = [t_rigl.rigl_update(T(params), T(masks), T(grads), 100, algo("set"),
                               torch.Generator().manual_seed(0)) for _ in range(2)]
    for name in SHAPES:
        assert torch.equal(runs[0][1][name]["w"], runs[1][1][name]["w"])
    with pytest.raises(ValueError, match="dense_momentum is missing"):
        t_rigl.rigl_update(T(params), T(masks), T(grads), 100, algo("snfs"))
    with pytest.raises(ValueError, match="bwd_masks is missing"):
        t_rigl.rigl_update(T(params), T(masks), T(grads), 100, algo("topkast"),
                           torch.Generator().manual_seed(0))


@pytest.mark.parametrize("ties", [False, True])
def test_dsr_update_matches_jax(ties):
    """DSR's global drop and random grow across layers, on the reference's
    draw: masks, weights and grown flags equal; total nnz kept while the
    per-layer counts move."""
    rng = np.random.default_rng(21 + ties)
    params, masks, _, _, _ = _problem(rng, False, ties)
    jalgo = j_rigl.SparseAlgo(schedule=JSched(delta_t=100, t_end=1000, alpha=0.3))
    talgo = t_rigl.SparseAlgo(schedule=TSched(delta_t=100, t_end=1000, alpha=0.3))
    key = jax.random.PRNGKey(9)
    total = sum(int(np.prod(s)) for s in SHAPES.values())
    draw = np.array(jax.random.uniform(key, (total,)))
    jp, jm, jg = j_rigl.dsr_update(J(params), J(masks), jnp.int32(100), jalgo, key)
    tp, tmk, tg = t_rigl.dsr_update(T(params), T(masks), 100, talgo,
                                    draw=torch.from_numpy(draw))
    for name in SHAPES:
        for got, want in ((tp, jp), (tmk, jm), (tg, jg)):
            np.testing.assert_array_equal(got[name]["w"].numpy(), np.asarray(want[name]["w"]))
    assert sum(int(tmk[n]["w"].sum()) for n in SHAPES) == sum(int(masks[n]["w"].sum())
                                                                for n in SHAPES)
    assert tp["c"]["w"] is not None and tmk["c"]["w"] is None


# ---------------------------------------------------------------------------
# gradual magnitude pruning and SNIP
# ---------------------------------------------------------------------------

def test_pruning_schedule_matches_jax():
    """The cubic ramp in float32 bit for bit, scalar and batched, and the
    prune-step predicate."""
    for kw in (dict(final_sparsity=0.8, begin_step=10, end_step=70, prune_every=20),
               dict(final_sparsity=0.9, begin_step=0, end_step=3, prune_every=1,
                    initial_sparsity=0.2),
               dict(final_sparsity=0.5, begin_step=5, end_step=5, prune_every=7)):
        js, ts = j_pruning.PruningSchedule(**kw), t_pruning.PruningSchedule(**kw)
        steps = np.arange(0, 90)
        np.testing.assert_array_equal(ts.target(steps).numpy(), np.asarray(js.target(steps)))
        for t in steps:
            assert np.float32(ts.target(int(t))) == np.float32(js.target(int(t)))
            assert ts.is_prune_step(int(t)) == bool(js.is_prune_step(int(t))), (kw, t)
        assert float(t_pruning.pruning_target_sparsity(ts, 12)) == float(js.target(12))


@pytest.mark.parametrize("ties", [False, True])
def test_prune_step_matches_jax(ties):
    """Two prune events: masks monotone, exactly round((1 - s_t) * N) kept
    per layer, masks and pruned weights equal to the reference's."""
    rng = np.random.default_rng(31 + ties)
    params, masks, _, _, _ = _problem(rng, False, ties)
    for n in SHAPES:  # pruning starts dense: all-ones masks, full weights
        masks[n]["w"] = np.ones(SHAPES[n], bool)
        params[n]["w"] = (rng.integers(1, 4, SHAPES[n]) if ties else
                          rng.standard_normal(SHAPES[n])).astype(np.float32)
    kw = dict(final_sparsity=0.8, begin_step=0, end_step=4, prune_every=2)
    js, ts = j_pruning.PruningSchedule(**kw), t_pruning.PruningSchedule(**kw)
    jp, jm, tp, tm = J(params), J(masks), T(params), T(masks)
    for t in (2, 4):
        prev = {n: tm[n]["w"].clone() for n in SHAPES}
        jp, jm = j_pruning.prune_step(jp, jm, jnp.int32(t), js)
        tp, tm = t_pruning.prune_step(tp, tm, t, ts)
        s_t = float(ts.target(t))
        for n in SHAPES:
            np.testing.assert_array_equal(tm[n]["w"].numpy(), np.asarray(jm[n]["w"]))
            np.testing.assert_array_equal(tp[n]["w"].numpy(), np.asarray(jp[n]["w"]))
            assert not (tm[n]["w"] & ~prev[n]).any()
            size = int(np.prod(SHAPES[n]))
            assert int(tm[n]["w"].sum()) == int(np.round(np.float32(1 - s_t) * size))
        assert tm["c"]["w"] is None


@pytest.mark.parametrize("saliency", ["weight_times_grad", "grad"])
def test_snip_masks_match_jax(saliency):
    """SNIP's one-shot masks with both saliencies, on tied and untied
    scores: equal to the reference's, exact counts, None off the map."""
    rng = np.random.default_rng(41)
    params, _, _, grads, _ = _problem(rng, False, True)
    sp = {"a/w": 0.7, "b/w": 0.9}
    got = t_pruning.snip_masks(T(params), T(grads), sp, saliency=saliency)
    want = j_pruning.snip_masks(J(params), J(grads), sp, saliency=saliency)
    for n, (K, N) in SHAPES.items():
        np.testing.assert_array_equal(got[n]["w"].numpy(), np.asarray(want[n]["w"]))
        assert int(got[n]["w"].sum()) == round((1 - sp[f"{n}/w"]) * K * N)
    assert got["c"]["w"] is None
    with pytest.raises(ValueError):
        t_pruning.snip_masks(T(params), T(grads), sp, saliency="magnitude")


# ---------------------------------------------------------------------------
# the Appendix H FLOP accounting
# ---------------------------------------------------------------------------

ARCHS = ("h2o-danube-1.8b", "mistral-large-123b", "qwen2-moe-a2.7b")


def test_flops_match_jax():
    """Every function of core/flops.py equal to the reference's numbers:
    layer tables, sparse forward FLOPs under uniform and ERK, every
    method's training FLOPs (pruning's mean over the f32 ramp), the paper's
    Fig. 2-left multipliers, and the LM parameter counts and model FLOPs of
    the port's three configs, full and smoke."""
    jl, tl = j_flops.resnet50_layers(), t_flops.resnet50_layers()
    assert [dataclasses.astuple(a) for a in jl] == [dataclasses.astuple(b) for b in tl]
    assert t_flops.model_fwd_flops(tl) == j_flops.model_fwd_flops(jl)
    conv, dense = t_flops.ConvSpec("c", 3, 3, 8, 16, 7, 7), t_flops.DenseSpec("d", 32, 10)
    assert t_flops.layer_fwd_flops(conv, 0.25) == j_flops.layer_fwd_flops(
        j_flops.ConvSpec("c", 3, 3, 8, 16, 7, 7), 0.25)
    assert dense.layer_spec() == TLayerSpec("d", (32, 10))
    assert conv.layer_spec().shape == conv.weight_shape == (3, 3, 8, 16)
    from repro.core.distributions import get_distribution as jdist
    from repro_torch.core.distributions import get_distribution as tdist

    for dist in ("uniform", "erk"):
        for s in (0.8, 0.9):
            jsp = jdist(dist, [l.layer_spec() for l in jl], s)
            tsp = tdist(dist, [l.layer_spec() for l in tl], s)
            assert t_flops.sparse_fwd_flops(tl, tsp) == j_flops.sparse_fwd_flops(jl, jsp)
            assert t_flops.resnet50_flop_multipliers(s, dist, 100) == \
                j_flops.resnet50_flop_multipliers(s, dist, 100)
    fd, fs = 8.2e9, 1.7e9
    for m in ("dense", "small_dense", "static", "snip", "set", "snfs", "rigl", "topkast"):
        assert t_flops.method_train_flops(m, fd, fs, delta_t=50) == \
            j_flops.method_train_flops(m, fd, fs, delta_t=50)
    assert t_flops.method_train_flops("topkast", fd, fs, f_sparse_bwd=2.1e9) == \
        j_flops.method_train_flops("topkast", fd, fs, f_sparse_bwd=2.1e9)
    kw = dict(final_sparsity=0.9, begin_step=800, end_step=2400, prune_every=100)
    assert t_flops.method_train_flops(
        "pruning", fd, fs, pruning_schedule=t_pruning.PruningSchedule(**kw),
        total_steps=3200) == j_flops.method_train_flops(
        "pruning", fd, fs, pruning_schedule=j_pruning.PruningSchedule(**kw),
        total_steps=3200)
    with pytest.raises(ValueError):
        t_flops.method_train_flops("lottery", fd, fs)
    for arch in ARCHS:
        for smoke in (False, True):
            tc, jc = t_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            assert t_flops.lm_param_count(tc) == j_flops.lm_param_count(jc), arch
            assert t_flops.lm_model_flops(tc, 4096) == j_flops.lm_model_flops(jc, 4096)
            assert t_flops.lm_model_flops(tc, 64, train=False) == \
                j_flops.lm_model_flops(jc, 64, train=False)


# ---------------------------------------------------------------------------
# topology telemetry
# ---------------------------------------------------------------------------

def _mask_tree(rng, p):
    return {"l0": {"w": rng.random((40, 24)) < p}, "l1": {"w": rng.random((16, 64)) < p},
            "emb": {"w": None}}


def test_topology_distances_match_jax():
    """drop/grow counts, Jaccard, graph-edit and NHD distances and the
    per-update record on seeded masks, given as numpy arrays and as
    tensors, equal to the reference's; TopologyTrace and the cross-method
    distances as the reference's (an empty trace reports zeros, a method
    of other shapes is skipped)."""
    rng = np.random.default_rng(51)
    seq = [_mask_tree(rng, 0.3)]
    for _ in range(3):  # each update swaps a few edges of the last mask
        nxt = {k: {"w": None if v["w"] is None else v["w"] ^ (rng.random(v["w"].shape) < 0.05)}
               for k, v in seq[-1].items()}
        seq.append(nxt)
    for a, b in zip(seq, seq[1:]):
        for conv in (lambda t: t, T):
            ta, tb = conv(a), conv(b)
            assert t_topo.drop_grow_counts(ta, tb) == j_topo.drop_grow_counts(a, b)
            assert t_topo.jaccard_distance(ta, tb) == j_topo.jaccard_distance(a, b)
            assert t_topo.graph_edit_distance(ta, tb) == j_topo.graph_edit_distance(a, b)
            assert t_topo.normalized_hamming_distance(ta, tb) == \
                j_topo.normalized_hamming_distance(a, b)
            assert t_topo.topology_delta(ta, tb, step=7) == j_topo.topology_delta(a, b, step=7)
    assert t_topo.TopologyTrace().summary() == j_topo.TopologyTrace().summary()
    tt, jt = t_topo.TopologyTrace(), j_topo.TopologyTrace()
    for i, (a, b) in enumerate(zip(seq, seq[1:])):
        prev = tt.snapshot(T(a))
        assert tt.record(prev, T(b), step=i) == jt.record(jt.snapshot(a), b, step=i)
    assert tt.summary() == jt.summary()
    other = {"l0": {"w": np.ones((8, 8), bool)}, "l1": {"w": np.ones((16, 64), bool)},
             "emb": {"w": None}}
    by = {"rigl": seq[0], "set": seq[2], "snip": seq[3], "small_dense": other}
    assert t_topo.cross_method_distances({k: T(v) for k, v in by.items()}) == \
        j_topo.cross_method_distances(by)
    with pytest.raises(ValueError, match="dense"):
        t_topo.drop_grow_counts(seq[0], dict(seq[1], emb={"w": np.ones(3, bool)}))


# ---------------------------------------------------------------------------
# trajectories on danube SMOKE from the reference's state
# ---------------------------------------------------------------------------

BLOCK = 16
# f32 on both sides: the same arithmetic summed in another order; relative
# to each leaf's largest magnitude (the tolerance of test_torch_train.py)
TOL = 1e-4
B, S = 4, 32


def _cfgs(method):
    kw = dict(sparsity=0.8, method=method, attn_kernel="flash_tight", delta_t=2)
    if method in ("snfs", "topkast"):
        kw.update(kernel="block_sparse", block_shape=(BLOCK, BLOCK),
                  kernel_block=(128, BLOCK, BLOCK))
    else:
        kw.update(kernel="masked")
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               sparse=SparseConfig(**kw), dtype="float32")
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**kw), dtype="float32")
    return jcfg, tcfg


def _bridge(st):
    """The reference train state -> the port's (pack, supersets and the
    dense momentum when the state has them)."""
    kw = {}
    if "pack" in st:
        flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
        kw["pack"] = {path_name(p): e for p, e in flat_k if e is not None}
    for k in ("bwd_masks", "dense_mom"):
        if k in st:
            kw[k] = _np(st[k])
    opt = {k: (int(v) if k == "count" else _np(v)) for k, v in st["opt"].items()}
    return bridge.train_state_from_flat(
        _np(st["params"]), _np(st["masks"]), opt=opt, step=int(st["step"]),
        nonfinite_steps=int(st["nonfinite_steps"]), device="cpu", **kw)


def _batch(jcfg, step):
    jb = batch_for(jcfg, step, B, S, learnable=True)
    return jb, {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}


def _close(got, want, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.float32(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    bound = TOL * max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _close_trees(t_tree, j_tree, what):
    want, got = _np(j_tree), tree_paths(t_tree)
    assert sorted(got) == sorted(want), what
    for n in want:
        _close(got[n], want[n], f"{what} {n}")


def _train_steps(jcfg, tcfg, st, tst, steps, opt_kw, lr_kw):
    j_step = jax.jit(make_train_step(jcfg, OptConfig(**opt_kw), LRSchedule(**lr_kw)))
    t_step = tsteps.make_train_step(tcfg, TOpt(**opt_kw), TLR(**lr_kw))
    for step in steps:
        jb, tb = _batch(jcfg, step)
        st, jm = j_step(st, jb)
        tst, tm = t_step(tst, tb)
        assert tst["step"] == int(st["step"]) == step + 1
        _close(tm["loss"], jm["loss"], f"step {step} loss")
        _close_trees(tst["params"], st["params"], f"step {step} params")
        for k in ("m", "v", "momentum"):
            if k in st["opt"]:
                _close_trees(tst["opt"][k], st["opt"][k], f"step {step} opt {k}")
        if "dense_mom" in st:
            _close_trees(tst["dense_mom"], st["dense_mom"], f"step {step} dense_mom")
    return st, tst


ADAM = dict(kind="adam", weight_decay=0.0, grad_clip=1.0)
SGD_WD = dict(kind="sgd", momentum=0.9, weight_decay=1e-3)
LR = dict(kind="warmup_cosine", base_lr=3e-3, warmup_steps=1, total_steps=8)


@pytest.mark.parametrize("method", ["set", "snfs", "topkast", "pruning", "snip"])
def test_train_cli_runs_every_method(method, tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu --method m``
    writes result.json with the topology summary and one record per
    drop/grow; pruning reaches its ramp's first target, SNIP the ERK
    sparsity."""
    from repro_torch.launch import train as ttrain

    kernel = ["--kernel", "masked"] if method in ("pruning", "snip") else \
        ["--kernel", "block_sparse", "--block", "16", "--alpha", "0.9"]
    ttrain.main(["--smoke", "--device", "cpu", "--method", method, "--steps", "6",
                 "--delta-t", "2", "--batch", "2", "--seq", "16",
                 "--workdir", str(tmp_path), *kernel])
    res = json.loads((tmp_path / "result.json").read_text())
    topo = res["topology"]
    assert set(topo) == {"n_updates", "dropped_total", "grown_total", "jaccard_dist_mean",
                         "graph_edit_dist_total", "nhd_mean"}
    # one drop/grow, at step 2 (t_end = 3/4 of 6 steps)
    updates = 1 if method in ("set", "snfs", "topkast") else 0
    assert topo["n_updates"] == len(res["topology_updates"]) == updates
    assert [u["step"] for u in res["topology_updates"]] == [2][:updates]
    if method in ("set", "snfs"):
        assert topo["dropped_total"] == topo["grown_total"] > 0
    if method == "pruning":  # one prune at step 0, to the ramp's target at step 1
        target = float(t_pruning.PruningSchedule(0.8, 0, 4, 20).target(1))
        assert abs(res["sparsity"] - target) < 1e-3
    else:
        assert abs(res["sparsity"] - 0.8) < 0.01
