"""Port training and serving under ``kernel='masked'`` (elementwise RigL
masks) vs the JAX package on danube SMOKE, f32: the same initial state
(carried across by the bridge, the masked superset carrier included) and
the same batches give the same trajectory over 3 steps, the same masks
after a RigL update, the same fused SGD epilogue (f32 state, and bf16 state
with stochastic rounding; under kernel='block_sparse' too, K7), the same
gating of the fused epilogue, and the same greedy token streams from the
serving engine.

On the CPU the port's masked kernels run their plain versions; the JAX side
runs its Pallas kernels in interpret mode.
"""
import dataclasses

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
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
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
from repro_torch.core.masks import flat_index, tree_paths  # noqa: E402
from repro_torch.core.pack import pack_entries, validate_pack  # noqa: E402
from repro_torch.data.synthetic import batch_for as t_batch_for  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

SPARSE = dict(sparsity=0.8, method="rigl", kernel="masked",
              kernel_block=(128, 16, 16), attn_kernel="flash_tight", delta_t=2)
# f32 on both sides: the same arithmetic summed in another order; relative
# to each leaf's largest magnitude.
TOL = 1e-4
B, S = 4, 32


def _cfgs(sparse=None, **model_kw):
    sp = dict(SPARSE, **(sparse or {}))
    base = {"dtype": "float32", **model_kw}
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               sparse=SparseConfig(**sp), **base)
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**sp), **base)
    return jcfg, tcfg


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _bridge(st):
    """The reference train state (carrier pack included) -> the port's."""
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


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.float32(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    bound = tol * max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _close_trees(t_tree, j_tree, what, tol=TOL):
    want = {n: v for n, v in j_tree_paths(j_tree).items()}
    got = tree_paths(t_tree)
    assert sorted(got) == sorted(want), what
    for n in want:
        _close(got[n], want[n], f"{what} {n}", tol)


def _run_both(jcfg, tcfg, jopt, topt, steps=3, lr_kw=None):
    lr_kw = lr_kw or dict(kind="warmup_cosine", base_lr=3e-3, warmup_steps=1,
                          total_steps=steps)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    tst = _bridge(st)
    assert validate_pack(tst["pack"]) == 14  # the carrier's 14 bwd_mask entries
    j_step = jax.jit(make_train_step(jcfg, jopt, LRSchedule(**lr_kw)))
    t_step = tsteps.make_train_step(tcfg, topt, TLR(**lr_kw))
    for step in range(steps):
        jb, tb = _batch(jcfg, step)
        st, jm = j_step(st, jb)
        tst, tm = t_step(tst, tb)
        assert tst["step"] == int(st["step"]) == step + 1
        _close(tm["loss"], jm["loss"], f"step {step} loss")
        _close(tm["grad_norm"], jm["grad_norm"], f"step {step} grad norm")
    return st, tst


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_masked_three_step_trajectory_matches_jax(kind):
    """RigL with elementwise masks and the Top-KAST superset carrier: sgd
    momentum with weight decay on the active weights; adam with
    microbatches=2 and remat.  Params and optimizer state at 1e-4."""
    if kind == "sgd":
        jcfg, tcfg = _cfgs()
        jopt, topt = (C(kind="sgd", momentum=0.9, weight_decay=1e-4) for C in (OptConfig, TOpt))
    else:
        jcfg, tcfg = _cfgs(microbatches=2, remat=True)
        jopt, topt = (C(kind="adam", weight_decay=0.0, grad_clip=1.0) for C in (OptConfig, TOpt))
    st, tst = _run_both(jcfg, tcfg, jopt, topt)
    _close_trees(tst["params"], st["params"], "params")
    for k in ("momentum", "m", "v"):
        if k in st["opt"]:
            _close_trees(tst["opt"][k], st["opt"][k], f"opt {k}")
    # weights stay zero off the mask
    for n, m in tree_paths(tst["masks"]).items():
        assert not tree_paths(tst["params"])[n][~m].any(), n


def test_masked_rigl_step_and_refresh_match_jax():
    """One elementwise drop/grow on the superset gradient: the masks agree
    element for element, params and Adam state at 1e-4; after refresh_pack
    the carrier holds the redrawn superset (the same tensors), B ⊇ A with
    the reference's per-layer count."""
    import math

    jcfg, tcfg = _cfgs()
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr_kw = dict(kind="warmup_cosine", base_lr=3e-3, warmup_steps=1, total_steps=8)
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    st = dict(st, step=jnp.int32(2))
    tst = _bridge(st)
    before = _flat(st["masks"])
    jb, tb = _batch(jcfg, 2)
    st, jm = jax.jit(make_rigl_step(jcfg, make_algo(jcfg, 8), LRSchedule(**lr_kw)))(st, jb)
    tst, tm = tsteps.make_rigl_step(tcfg, tsteps.make_algo(tcfg, 8), TLR(**lr_kw))(tst, tb)
    _close(tm["loss"], jm["loss"], "rigl-step loss")
    want = _flat(st["masks"])
    moved = 0
    for n, m in tree_paths(tst["masks"]).items():
        np.testing.assert_array_equal(m.numpy(), want[n], err_msg=n)
        assert m.sum() == before[n].sum(), n
        moved += int((m.numpy() != before[n]).sum())
    assert moved
    _close_trees(tst["params"], st["params"], "rigl-step params")
    for k in ("m", "v"):
        _close_trees(tst["opt"][k], st["opt"][k], f"rigl-step opt {k}")
    st = refresh_pack(st, jcfg)
    tst = tsteps.refresh_pack(tst, tcfg)
    assert validate_pack(tst["pack"]) == 14
    bwd, masks = tree_paths(tst["bwd_masks"]), tree_paths(tst["masks"])
    want_b = _flat(st["bwd_masks"])
    for n, e in pack_entries(tst["pack"]):
        assert e["bwd_mask"] is bwd[n], f"{n}: the carrier is not the fresh superset"
        a, b = masks[n].numpy(), bwd[n].numpy()
        assert not (a & ~b).any(), n
        assert b.sum() == want_b[n].sum() == min(b.size, a.sum() + math.ceil(0.1 * b.size))


def test_fused_seed_follows_the_reference_flatten_order():
    """K19's seed per leaf is ``step * int32(1000003) + int32(i)`` read as
    uint32, i the leaf's index in jax.tree_util.tree_flatten(masks,
    is_leaf=is None): None leaves counted, keys sorted, list order; the
    int32 product wraps past step 2147."""
    jcfg, _ = _cfgs()
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    flat, _ = jax.tree_util.tree_flatten_with_path(st["masks"], is_leaf=lambda x: x is None)
    want = {path_name(p): i for i, (p, _) in enumerate(flat)}
    tst = _bridge(st)
    got = flat_index(tst["masks"])
    assert got == want
    assert any(m is None for _, m in flat)  # None leaves really were counted
    for step in (0, 3, 2147, 2148, 10**6):
        for i in (0, 5, len(flat) - 1):
            with np.errstate(over="ignore"):
                ref = (np.array([step], np.int32) * np.int32(1000003) + np.int32(i))
            assert tsteps.fused_seed(step, i) == int(ref.view(np.uint32)[0]), (step, i)


# the block-sparse pack of the smoke config: 16x16 blocks (its dims are
# 16-multiples)
BLOCK_SPARSE = {"kernel": "block_sparse", "block_shape": (16, 16)}


@pytest.mark.parametrize("kernel,state_dtype", [
    pytest.param("masked", "float32", id="float32"),
    pytest.param("masked", "bfloat16", id="bfloat16"),
    pytest.param("block_sparse", "float32", id="block_sparse-float32"),
    pytest.param("block_sparse", "bfloat16", id="block_sparse-bfloat16")])
def test_fused_epilogue_matches_jax_and_unfused(kernel, state_dtype):
    """SGD with momentum through the fused epilogue (the plain versions of
    K19 under masked, K7 under block_sparse): the port's fused trajectory
    against the reference's fused one, and the port's fused against its
    unfused, at the reference's own bounds (tests/test_fused_epilogue.py:
    params 2e-6, momentum 1e-5, loss 1e-5 with f32 state; bf16 state:
    momentum stored exactly in bf16 and within 2e-2 of the largest momentum
    entry of the unfused run)."""
    jopt, topt = (C(kind="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=0.0,
                    state_dtype=state_dtype) for C in (OptConfig, TOpt))
    lr_kw = dict(base_lr=3e-3, warmup_steps=0, total_steps=10)
    mode = BLOCK_SPARSE if kernel == "block_sparse" else {}
    jcfg, tcfg = _cfgs({"fused_epilogue": True, **mode})
    st, tst = _run_both(jcfg, tcfg, jopt, topt, steps=2, lr_kw=lr_kw)
    tol = TOL if state_dtype == "float32" else 2.0**-7
    _close_trees(tst["params"], st["params"], "fused params")
    _close_trees(tst["opt"]["momentum"], st["opt"]["momentum"], "fused momentum", tol)
    for m in tree_paths(tst["opt"]["momentum"]).values():
        assert m.dtype == (torch.bfloat16 if state_dtype == "bfloat16" else torch.float32)

    _, ucfg = _cfgs({"fused_epilogue": False, **mode})
    ust, _ = tsteps.init_train_state(ucfg, topt, seed=0, device="cpu")
    fst, _ = tsteps.init_train_state(tcfg, topt, seed=0, device="cpu")
    losses = {}
    for name, cfg, s_ in (("unfused", ucfg, ust), ("fused", tcfg, fst)):
        step = tsteps.make_train_step(cfg, topt, TLR(**lr_kw))
        for t in range(2):
            s_, m = step(s_, _batch(jcfg, t)[1])
        losses[name] = float(m["loss"])
        (ust if name == "unfused" else fst).update(s_)
    diff = lambda a, b: max(float((x.float() - y.float()).abs().max()) for x, y in zip(
        tree_paths(a).values(), tree_paths(b).values()))
    mref = max(float(x.float().abs().max()) for x in tree_paths(ust["opt"]["momentum"]).values())
    if state_dtype == "float32":
        assert diff(ust["params"], fst["params"]) < 2e-6
        assert diff(ust["opt"]["momentum"], fst["opt"]["momentum"]) < 1e-5
        assert abs(losses["fused"] - losses["unfused"]) < 1e-5
    else:
        assert diff(ust["opt"]["momentum"], fst["opt"]["momentum"]) < 2e-2 * max(mref, 1e-3)


@pytest.mark.parametrize("opt_kw,needle", [
    (dict(kind="adam"), "sgd"), (dict(nesterov=True), "nesterov"),
    (dict(grad_clip=1.0), "grad_clip")])
def test_fused_rejects_unsupported_optimizer(opt_kw, needle):
    """The reference's gating (tests/test_fused_epilogue.py), same wording."""
    _, tcfg = _cfgs({"fused_epilogue": True})
    with pytest.raises(ValueError, match=needle):
        tsteps.make_train_step(tcfg, TOpt(**{"kind": "sgd", "grad_clip": 0.0, **opt_kw}), TLR())


@pytest.mark.parametrize("what", ["snfs", "microbatches", "dense", "bf16_state"])
def test_fused_rejects_snfs_microbatches_dense_and_bf16_compute(what):
    opt = TOpt(kind="sgd", grad_clip=0.0)
    if what == "snfs":
        _, cfg = _cfgs({"fused_epilogue": True, "method": "snfs"})
        match = "snfs"
    elif what == "microbatches":
        _, cfg = _cfgs({"fused_epilogue": True}, microbatches=2)
        match = "microbatches"
    elif what == "dense":
        _, cfg = _cfgs({"fused_epilogue": True, "kernel": "dense"})
        match = "dispatch"
    else:
        _, cfg = _cfgs({"fused_epilogue": True}, dtype="bfloat16")
        with pytest.raises(ValueError, match="state_dtype"):
            tsteps.make_train_step(cfg, opt, TLR())
        # the same combination with bf16 state is accepted (SR mode)
        tsteps.make_train_step(cfg, dataclasses.replace(opt, state_dtype="bfloat16"), TLR())
        return
    with pytest.raises(ValueError, match=match):
        tsteps.make_train_step(cfg, opt, TLR())


def test_fused_block_sparse_and_bf16_adam_state_are_not_ported():
    """The fused epilogue under kernel='block_sparse' (K7) is ported: the
    step builds and its fused leaves' pack entries carry the epilogue's
    operands beside the superset view.  bf16 Adam state is ported too:
    the step builds from bf16 moments and its first update leaves f32
    ones, equal bit for bit to the first moments of an f32 state (both
    start at zero, so ``b1 * m`` is zero in either dtype)."""
    _, cfg = _cfgs({"fused_epilogue": True, **BLOCK_SPARSE})
    opt = TOpt(kind="sgd", grad_clip=0.0)
    tsteps.make_train_step(cfg, opt, TLR())
    st, _ = tsteps.init_train_state(cfg, opt, seed=0, device="cpu")
    entries = dict(pack_entries(tsteps._fused_pack(st, opt)))
    assert sorted(entries) == sorted(tree_paths(st["masks"]))
    assert all({"mom", "seed", "bidx", "ridx"} <= set(e) for e in entries.values())
    _, cfg = _cfgs()
    batch = t_batch_for(cfg, 0, 2, 16, learnable=True, device="cpu")
    moments = {}
    for dt in ("bfloat16", "float32"):
        adam = TOpt(kind="adam", state_dtype=dt)
        st, _ = tsteps.init_train_state(cfg, adam, seed=0, device="cpu")
        assert {t.dtype for t in tree_paths(st["opt"]["m"]).values()} == {
            getattr(torch, dt)}
        st, _ = tsteps.make_train_step(cfg, adam, TLR())(st, batch)
        moments[dt] = {k: tree_paths(st["opt"][k]) for k in ("m", "v")}
    for k in ("m", "v"):
        assert {t.dtype for t in moments["bfloat16"][k].values()} == {torch.float32}
        for n, t in moments["float32"][k].items():
            assert torch.equal(moments["bfloat16"][k][n], t), (k, n)


def test_masked_engine_streams_match_jax():
    """The serving engine under kernel='masked' (elementwise masks, pack
    None in the port; the reference serves the state's carrier, whose
    forward is the same) gives the reference engine's greedy tokens."""
    jcfg, tcfg = _cfgs()
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    tp = bridge.params_from_flat(_flat(st["params"]), "cpu")
    tm = bridge.masks_from_flat(_flat(st["masks"]), tp, "cpu")
    req = dict(prompt_lens=(5, 20, 9), gen_lens=(6, 3, 9, 4))
    jreqs, treqs = j_requests(jcfg, 5, **req), t_requests(tcfg, 5, **req)
    for Engine, cfg, params, masks, pack, reqs in (
            (JEngine, jcfg, st["params"], st["masks"], st.get("pack"), jreqs),
            (TEngine, tcfg, tp, tm, None, treqs)):
        engine = Engine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack)
        for r in reqs:
            assert engine.submit(r)
        while len(engine.queue) or engine.active.any():
            engine.step(now=0.0)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert len({t for r in jreqs for t in r.generated}) > 3


def test_masked_clis_on_cpu_and_without_a_card(tmp_path, monkeypatch, capsys):
    """``--kernel masked`` through both CLIs on the CPU (plain versions):
    every request served, the training run's drop/grow keeps the sparsity;
    without ``--device cpu`` and without a card both raise."""
    import json

    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    stats = tserve.main(["--smoke", "--device", "cpu", "--kernel", "masked",
                         "--attn-kernel", "flash_tight", "--requests", "3",
                         "--max-len", "64", "--capacity", "2"])
    assert stats["requests"] == 3 and stats["failed"] == 0
    ttrain.main(["--smoke", "--device", "cpu", "--kernel", "masked", "--steps", "6",
                 "--delta-t", "2", "--batch", "2", "--seq", "16",
                 "--workdir", str(tmp_path)])
    res = json.loads((tmp_path / "result.json").read_text())
    assert abs(res["sparsity"] - 0.8) < 0.01
    assert all(np.isfinite(r["loss"]) for r in res["metrics"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--kernel", "masked", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--kernel", "masked", "--steps", "2",
                     "--workdir", str(tmp_path / "nocard")])


def test_masked_train_step_refuses_a_carrier_without_the_superset():
    """Under kernel='masked' with supersets, a mask leaf whose carrier
    entry is missing would run its weight gradient on the forward mask;
    the step refuses it (the reference's totality guard)."""
    jcfg, tcfg = _cfgs()
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    tst = _bridge(st)
    tst["pack"]["layers"][0]["mlp"]["wg"]["w"] = None
    step = tsteps.make_train_step(tcfg, TOpt(), TLR())
    with pytest.raises(RuntimeError, match=r"layers/0/mlp/wg/w.*\(bwd_mask\)"):
        step(tst, _batch(jcfg, 0)[1])
