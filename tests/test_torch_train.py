"""Port training vs the JAX package on danube SMOKE (block 16, block-sparse
kernels, flash_tight attention, f32): the same initial state (carried
across by the bridge) and the same batches give the same losses, params
and optimizer state over 3 steps, the same masks and packs after one RigL
update, and the same non-finite guard.

On the CPU the port's kernels run their plain versions; the JAX side runs
its Pallas kernels in interpret mode.  The port's own random draws (the
Top-KAST superset after a refresh, the data stream) come from
``torch.Generator``s, not threefry: for those the tests check invariants.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import (  # noqa: E402
    init_train_state,
    make_algo,
    make_rigl_step,
    make_train_step,
    refresh_pack,
)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import block_mask_of, tree_map, tree_paths  # noqa: E402
from repro_torch.core.pack import pack_entries, pack_mismatch, validate_pack  # noqa: E402
from repro_torch.models.model import lm_loss as t_lm_loss  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

BLOCK = 16
SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(BLOCK, BLOCK), kernel_block=(128, BLOCK, BLOCK),
              attn_kernel="flash_tight", delta_t=2)
# f32 on both sides: the same arithmetic summed in another order; relative
# to each leaf's largest magnitude.
TOL = 1e-4
B, S = 4, 32


def _cfgs(**model_kw):
    base = dict(dtype="float32", **model_kw)
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               sparse=SparseConfig(**SPARSE), **base)
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**SPARSE), **base)
    return jcfg, tcfg


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _bridge(st):
    """The reference train state -> the port's, through the bridge."""
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    opt = {k: (int(v) if k == "count" else _flat(v)) for k, v in st["opt"].items()}
    return bridge.train_state_from_flat(
        _flat(st["params"]), _flat(st["masks"]),
        pack={path_name(p): e for p, e in flat_k if e is not None},
        bwd_masks=_flat(st["bwd_masks"]), opt=opt, step=int(st["step"]),
        nonfinite_steps=int(st["nonfinite_steps"]), device="cpu")


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
    want = _flat(j_tree)
    got = tree_paths(t_tree)
    assert sorted(got) == sorted(want), what
    for n in want:
        _close(got[n], want[n], f"{what} {n}")


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_three_step_trajectory_matches_jax(kind):
    """sgd: momentum 0.9 with Nesterov off and weight decay on the active
    weights; adam: train_loop's defaults (no decay, clip 1.0) with
    microbatches=2 (gradient accumulation) and remat (checkpoint regions)."""
    if kind == "sgd":
        jcfg, tcfg = _cfgs()
        jopt, topt = (C(kind="sgd", momentum=0.9, weight_decay=1e-4)
                      for C in (OptConfig, TOpt))
    else:
        jcfg, tcfg = _cfgs(microbatches=2, remat=True)
        jopt, topt = (C(kind="adam", weight_decay=0.0, grad_clip=1.0)
                      for C in (OptConfig, TOpt))
    lr_kw = dict(kind="warmup_cosine", base_lr=3e-3, warmup_steps=1, total_steps=3)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    tst = _bridge(st)
    j_step = jax.jit(make_train_step(jcfg, jopt, LRSchedule(**lr_kw)))
    t_step = tsteps.make_train_step(tcfg, topt, TLR(**lr_kw))
    for step in range(3):
        jb, tb = _batch(jcfg, step)
        st, jm = j_step(st, jb)
        tst, tm = t_step(tst, tb)
        assert tst["step"] == int(st["step"]) == step + 1
        _close(tm["loss"], jm["loss"], f"step {step} loss")
        _close(tm["grad_norm"], jm["grad_norm"], f"step {step} grad norm")
        _close(tm["lr"], jm["lr"], f"step {step} lr")
        _close_trees(tst["params"], st["params"], f"step {step} params")
        for k in ("momentum", "m", "v"):
            if k in st["opt"]:
                _close_trees(tst["opt"][k], st["opt"][k], f"step {step} opt {k}")
        if kind == "adam":
            assert int(tst["opt"]["count"]) == int(st["opt"]["count"])
    assert int(tst["nonfinite_steps"]) == 0


def test_rigl_step_and_refresh_match_jax():
    """One drop/grow on the superset gradient, then refresh_pack: the masks
    agree block for block and the forward packs element for element; the
    port's redrawn superset (its own draws) keeps B ⊇ A and the
    reference's block count per layer."""
    jcfg, tcfg = _cfgs()
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr_kw = dict(kind="warmup_cosine", base_lr=3e-3, warmup_steps=1, total_steps=8)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    st = dict(st, step=jnp.int32(2))  # an update step (t % delta_t == 0)
    tst = _bridge(st)
    algo = make_algo(jcfg, 8)
    jb, tb = _batch(jcfg, 2)
    st, jm = jax.jit(make_rigl_step(jcfg, algo, LRSchedule(**lr_kw)))(st, jb)
    tst, tm = tsteps.make_rigl_step(tcfg, tsteps.make_algo(tcfg, 8), TLR(**lr_kw))(tst, tb)
    _close(tm["loss"], jm["loss"], "rigl-step loss")
    want_masks = _flat(st["masks"])
    for n, m in tree_paths(tst["masks"]).items():
        np.testing.assert_array_equal(
            block_mask_of(m, (BLOCK, BLOCK)).numpy(),
            np.asarray(block_mask_of(want_masks[n], (BLOCK, BLOCK))), err_msg=n)
    _close_trees(tst["params"], st["params"], "rigl-step params")
    for k in ("m", "v"):
        _close_trees(tst["opt"][k], st["opt"][k], f"rigl-step opt {k}")

    st = refresh_pack(st, jcfg)
    tst = tsteps.refresh_pack(tst, tcfg)
    assert validate_pack(tst["pack"]) == 14
    assert int(pack_mismatch(tst["masks"], tst["pack"], (BLOCK, BLOCK),
                             bwd_masks=tst["bwd_masks"])) == 0
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    want_pack = {path_name(p): e for p, e in flat_k if e is not None}
    want_bwd = _flat(st["bwd_masks"])
    masks = tree_paths(tst["masks"])
    for n, e in pack_entries(tst["pack"]):
        for k in ("idx", "cnt", "ridx", "rcnt"):
            np.testing.assert_array_equal(e[k].numpy(), np.asarray(want_pack[n][k]),
                                          err_msg=f"{n} {k}")
        a = block_mask_of(masks[n], (BLOCK, BLOCK)).numpy()
        b = block_mask_of(tree_paths(tst["bwd_masks"])[n], (BLOCK, BLOCK)).numpy()
        assert not (a & ~b).any(), f"{n}: superset does not contain the mask"
        assert b.sum() == np.asarray(block_mask_of(want_bwd[n], (BLOCK, BLOCK))).sum()
        assert b.sum() == min(b.size, a.sum() + math.ceil(0.1 * b.size))


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_policy_trains_with_equal_gradients(policy):
    """Both remat policies train: a step under ``remat_policy`` (``'dots'``
    saves each region's dense-product outputs, the reference's
    jax.checkpoint_policies.checkpoint_dots) gives the same loss, params
    and momentum, bit for bit, as the same step without remat (what is
    saved changes, not the numbers).  A forward without autograd (serving)
    builds no remat region and runs under either."""
    _, tcfg = _cfgs()
    opt = TOpt(kind="sgd", momentum=0.9, weight_decay=0.0)
    lr = TLR(kind="constant", base_lr=1e-2, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "targets": (toks + 1) % tcfg.vocab_size}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        st, _ = tsteps.init_train_state(cfg, opt, seed=0, device="cpu")
        with torch.no_grad():
            assert math.isfinite(float(t_lm_loss(st["params"], cfg, batch, masks=st["masks"],
                                                 pack=st.get("pack"))))
        st, m = tsteps.make_train_step(cfg, opt, lr)(st, batch)
        assert math.isfinite(float(m["loss"])) and st["step"] == 1
        out[remat] = (float(m["loss"]), tree_paths(st["params"]),
                      tree_paths(st["opt"]["momentum"]))
    assert out[True][0] == out[False][0]
    for i in (1, 2):
        for n, t in out[False][i].items():
            assert torch.equal(out[True][i][n], t), n


def test_nonfinite_batch_leaves_state_unchanged():
    """A batch whose loss is NaN (poison through the batch, as the
    reference's guard test) keeps params and optimizer state bit for bit,
    advances the step, counts 1, and the next clean batch trains."""
    jcfg, tcfg = _cfgs()
    opt = TOpt(kind="sgd", momentum=0.9, weight_decay=0.0)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg,
                                OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0))
    tst = _bridge(st)
    loss = lambda p, b, masks=None, pack=None: t_lm_loss(
        p, tcfg, b, masks=masks, pack=pack) + b["poison"]
    step = tsteps.make_train_step(tcfg, opt, TLR(kind="constant", base_lr=1e-2,
                                                 warmup_steps=0), loss_fn=loss)
    _, tb = _batch(jcfg, 0)
    tst, m1 = step(tst, dict(tb, poison=torch.tensor(0.0)))
    assert int(m1["nonfinite_steps"]) == 0 and math.isfinite(float(m1["loss"]))
    before = {k: {n: t.clone() for n, t in tree_paths(tst[k] if k == "params"
                                                       else tst["opt"][k]).items()}
              for k in ("params", "momentum")}
    tst, m2 = step(tst, dict(tb, poison=torch.tensor(float("nan"))))
    assert not math.isfinite(float(m2["loss"]))
    assert int(m2["nonfinite_steps"]) == 1 and tst["step"] == 2
    for k, tree in (("params", tst["params"]), ("momentum", tst["opt"]["momentum"])):
        for n, t in tree_paths(tree).items():
            assert torch.equal(t, before[k][n]), f"{k} {n} changed"
    tst, m3 = step(tst, dict(tb, poison=torch.tensor(0.0)))
    assert int(m3["nonfinite_steps"]) == 1
    assert any(not torch.equal(t, before["params"][n])
               for n, t in tree_paths(tst["params"]).items())


def test_stale_pack_raises_in_train_loop(tmp_path, monkeypatch):
    """A topology update without refresh_pack leaves the pack stale; the
    loop's log-cadence check raises instead of training the wrong
    topology."""
    from repro_torch.launch import train as tl

    _, tcfg = _cfgs()
    # alpha 0.9: the update at step 2 (t_end = 4) moves most blocks
    tcfg = dataclasses.replace(tcfg, sparse=dataclasses.replace(tcfg.sparse, alpha=0.9))
    monkeypatch.setattr(tl, "refresh_pack", lambda state, cfg: state)
    with pytest.raises(RuntimeError, match="stale"):
        tl.train_loop(tcfg, steps=6, batch=2, seq=16, workdir=str(tmp_path),
                      log_every=1, device="cpu")


def test_train_loop_runs_updates_and_writes_result(tmp_path):
    """train_loop end to end on the CPU: updates at every delta_t, finite
    losses, pack never stale, sparsity kept, result.json written; and the
    reference's lm_loss (dense masked path) agrees with the port's kernel
    path on the trained state."""
    import json

    jcfg, tcfg = _cfgs()
    tst, log = train_loop(tcfg, steps=8, batch=2, seq=16, workdir=str(tmp_path),
                          log_every=1, device="cpu")
    assert [r["step"] for r in log] == list(range(1, 9))
    assert all(math.isfinite(r["loss"]) and r["pack_stale"] == 0 for r in log)
    # updates at steps 2 and 4 (t_end = 6): their records carry the loss only
    assert [r["step"] for r in log if "lr" not in r] == [3, 5]
    res = json.loads((tmp_path / "result.json").read_text())
    assert abs(res["sparsity"] - 0.8) < 0.01 and res["nnz"] > 0
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16))
    jnp_of = lambda tree: tree_map(
        lambda _, t: None if t is None else jnp.asarray(t.numpy()), tree)
    dense = dataclasses.replace(jcfg, sparse=dataclasses.replace(
        jcfg.sparse, kernel="dense", attn_kernel="dense"))
    want = j_lm_loss(jnp_of(tst["params"]), dense,
                     {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)},
                     masks=jnp_of(tst["masks"]))
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(toks)}
    got = t_lm_loss(tst["params"], tcfg, tb, masks=tst["masks"], pack=tst["pack"])
    _close(got, want, "loss of the trained state")


# ---------------------------------------------------------------------------
# host-side pieces, one by one, on numpy-made inputs handed to both packages
# ---------------------------------------------------------------------------

from repro.core import rigl as j_rigl  # noqa: E402
from repro.core.schedules import UpdateSchedule as JSched  # noqa: E402
from repro.optim import apply_opt as j_apply_opt, init_opt as j_init_opt  # noqa: E402
from repro_torch.core import rigl as t_rigl  # noqa: E402
from repro_torch.core.schedules import UpdateSchedule as TSched  # noqa: E402
from repro_torch.optim.optimizers import apply_opt as t_apply_opt  # noqa: E402
from repro_torch.optim.optimizers import init_opt as t_init_opt  # noqa: E402


def _layer_problem(rng, block, ties):
    """Two masked layers and a dense one: weights zero off the mask, a dense
    gradient.  ``ties`` draws |w| and |g| from three values, so the
    exact-count ranking must break many ties, as the reference does (by the
    lower flat index)."""
    out = {}
    for name, (K, N) in (("a", (64, 96)), ("b", (48, 32))):
        if block:
            bm = rng.random((K // 16, N // 16)) < 0.4
            m = np.repeat(np.repeat(bm, 16, 0), 16, 1)
        else:
            m = rng.random((K, N)) < 0.3
        draw = (lambda s: rng.integers(1, 4, s).astype(np.float32)) if ties else \
            (lambda s: rng.standard_normal(s).astype(np.float32))
        out[name] = (draw((K, N)) * m, m, draw((K, N)))
    dense = rng.standard_normal((8, 8)).astype(np.float32)
    params = {"a": {"w": out["a"][0]}, "b": {"w": out["b"][0]}, "c": {"w": dense}}
    masks = {"a": {"w": out["a"][1]}, "b": {"w": out["b"][1]}, "c": {"w": None}}
    grads = {"a": {"w": out["a"][2]}, "b": {"w": out["b"][2]}, "c": {"w": dense}}
    return params, masks, grads


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t", [100, 700])
def test_rigl_update_matches_jax(block, ties, t):
    """drop/grow with exact counts: the masks, the zero-initialised grown
    weights and the grown flags equal the reference's, element for element,
    elementwise and in 16x16 block mode, with and without ties."""
    params, masks, grads = _layer_problem(np.random.default_rng(t + 2 * block + ties),
                                          block, ties)
    kw = dict(method="rigl", block_shape=(16, 16) if block else None)
    jalgo = j_rigl.SparseAlgo(schedule=JSched(delta_t=100, t_end=1000, alpha=0.3), **kw)
    talgo = t_rigl.SparseAlgo(schedule=TSched(delta_t=100, t_end=1000, alpha=0.3), **kw)
    J = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    T = lambda tree: tree_map(lambda _, a: None if a is None else torch.from_numpy(a), tree)
    jp, jm, jg = j_rigl.rigl_update(J(params), J(masks), J(grads), jnp.int32(t), jalgo,
                                    jax.random.PRNGKey(0))
    tp, tmk, tg = t_rigl.rigl_update(T(params), T(masks), T(grads), t, talgo)
    moved = 0
    for name in ("a", "b"):
        for got, want in ((tp, jp), (tmk, jm), (tg, jg)):
            np.testing.assert_array_equal(got[name]["w"].numpy(), np.asarray(want[name]["w"]))
        assert tmk[name]["w"].sum() == masks[name]["w"].sum()
        moved += int((tmk[name]["w"].numpy() != masks[name]["w"]).sum())
    # early (fraction 0.29) on distinct values the topology must move; late
    # (0.06) small block layers drop nothing, and with ties the reference
    # may regrow exactly what it dropped
    assert moved or ties or t > 100
    assert tp["c"]["w"] is not None and tmk["c"]["w"] is None


def units_of(x, bs):
    return np.asarray(block_mask_of(x, bs)) if bs else x


@pytest.mark.parametrize("block", [False, True])
def test_superset_draw_invariants(block):
    """The port's own superset draw (torch.Generator, not threefry): B ⊇ A,
    exactly min(total, |A| + ceil(extra * total)) units, and every nonzero
    inactive weight ranks above the random zeros, as in the reference."""
    rng = np.random.default_rng(5)
    bs = (16, 16) if block else None
    if block:
        bm = rng.random((6, 8)) < 0.3
        m = np.repeat(np.repeat(bm, 16, 0), 16, 1)
    else:
        m = rng.random((96, 128)) < 0.3
    w = rng.standard_normal(m.shape).astype(np.float32) * m
    # a trained inactive unit (e.g. a dropped one keeping its value)
    r, c = np.argwhere(~units_of(m, bs))[0] * (16 if block else 1)
    w[r, c] = 5.0
    gen = torch.Generator().manual_seed(0)
    b = t_rigl.topkast_superset_layer(torch.from_numpy(w), torch.from_numpy(m), 0.1,
                                      gen, block_shape=bs).numpy()
    units = lambda x: units_of(x, bs)
    ua, ub = units(m), units(b)
    assert not (ua & ~ub).any()
    assert ub.sum() == min(ub.size, ua.sum() + math.ceil(0.1 * ub.size))
    trained = units(w != 0) & ~ua
    assert trained.any() and not (trained & ~ub).any()
    if block:
        np.testing.assert_array_equal(b, np.repeat(np.repeat(ub, 16, 0), 16, 1))


def test_update_schedule_and_lr_match_jax():
    """f_decay(t) for every decay and the LR kinds, in float32 as the
    reference evaluates them (the drop count floor(f * n) reads the last
    bits); and the update-step predicate."""
    for decay in ("cosine", "constant", "linear", "inverse_power"):
        js, ts = JSched(delta_t=10, t_end=95, alpha=0.3, decay=decay), \
            TSched(delta_t=10, t_end=95, alpha=0.3, decay=decay)
        for t in (0, 7, 10, 50, 90, 94, 95):
            assert np.float32(ts.fraction(t)) == np.float32(js.fraction(jnp.int32(t))), (decay, t)
            assert ts.is_update_step(t) == bool(js.is_update_step(t)), (decay, t)
    for kind, kw in (("warmup_cosine", {}), ("constant", {}),
                     ("step_drops", dict(drop_steps=(3, 7), drop_factor=0.1))):
        jl, tl_ = LRSchedule(kind=kind, base_lr=3e-3, warmup_steps=4, total_steps=10, **kw), \
            TLR(kind=kind, base_lr=3e-3, warmup_steps=4, total_steps=10, **kw)
        for s in range(12):
            assert np.float32(tl_(s)) == pytest.approx(np.float32(jl(s)), rel=1e-6), (kind, s)


@pytest.mark.parametrize("kind", ["sgd", "nesterov", "adam"])
def test_apply_opt_matches_jax(kind):
    """Two optimizer updates on a small tree: params and state as the
    reference's (the port updates in place); adam with a binding clip; and
    ``ok=False`` keeps every leaf bit for bit."""
    rng = np.random.default_rng(9)
    shapes = {"a": (16, 24), "b": (24,), "c": (3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(kind="adam", grad_clip=0.5, weight_decay=1e-2) if kind == "adam" else \
        dict(kind="sgd", momentum=0.9, nesterov=kind == "nesterov", weight_decay=1e-3)
    jcfg, tcfg = OptConfig(**kw), TOpt(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = j_init_opt(jcfg, jp), t_init_opt(tcfg, tp)
    for step in range(2):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, js = j_apply_opt(jcfg, {k: jnp.asarray(v) for k, v in g.items()}, js, jp, 1e-2)
        t_apply_opt(tcfg, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, 1e-2)
        for k in shapes:
            _close(tp[k], jp[k], f"step {step} {k}")
            for s in ("momentum", "m", "v"):
                if s in js:
                    _close(ts[s][k], js[s][k], f"step {step} {s} {k}")
    before = {k: v.clone() for k, v in tp.items()}
    g = {k: torch.full(s, float("nan")) for k, s in shapes.items()}
    t_apply_opt(tcfg, g, ts, tp, 1e-2, ok=torch.tensor(False))
    assert all(torch.equal(tp[k], before[k]) for k in shapes)


def test_train_step_refuses_a_pack_without_the_superset_view():
    """Under dispatch with backward supersets, a pack entry without its
    ``bidx`` view would run that layer's weight gradient on the forward
    topology; the step refuses it (the reference's totality guard)."""
    jcfg, tcfg = _cfgs()
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    tst = _bridge(st)
    e = tst["pack"]["layers"][1]["attn"]["wk"]["w"]
    for k in ("bidx", "bcnt", "bnnz"):
        del e[k]
    step = tsteps.make_train_step(tcfg, TOpt(), TLR())
    with pytest.raises(RuntimeError, match=r"layers/1/attn/wk/w.*backward-superset"):
        step(tst, _batch(jcfg, 0)[1])
