"""Port xLSTM (xlstm-1.3b) vs the JAX package on the smoke config, block 16.

Covers the slice bottom up: the config copy, the init layout and ERK map
(sLSTM's recurrent bank ``r`` a bare 3-D leaf), the pack's grouped entry
for ``r``; ``mlstm`` over several chunks with its state and gradients,
``slstm`` and its gradients; ``mlstm_decode``/``slstm_decode`` stepped
token by token against the full forward; ``lm_loss`` and its gradients
(the tied table's included) under dense, masked and block_sparse;
prefill and decode with an inactive slot frozen bit for bit; the engine's
greedy streams; the paged engine (no KV pool) and the prefix cache
refused; the bank routed through ``grouped_linear`` once per step, and
that grouped call against the reference's grouped Pallas kernel in
interpret mode at the bank's layout.

The port's kernel modes run their kernels' plain versions on the CPU.  The
reference runs kernel='dense' with the same masks (``w * m`` in every
matmul: the same function, and a masked gradient like the kernels'), so no
interpret-mode kernel runs outside the one grouped-call test.  Tolerances,
relative to the largest magnitude compared: 1e-4 for f32 results (the
same products summed in another order, through exponential gates and 150
recurrent steps); the embedding's bf16 rounding is the same on both sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core import pack as jpack  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.models import xlstm as jX  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.training.steps import sparsity_map as j_sparsity_map  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.distributions import sparsity_map  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import configure_kernel, init_serving_state  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

ARCH = "xlstm-1.3b"
BLOCK = 16
TOL = 1e-4
MODES = ("dense", "masked", "block_sparse")


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _jx(tree):
    """A port tree (tensors, None leaves) as the reference's (jnp arrays)."""
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


_STATES = {}


def _state(mode):
    """The port's serve state of the smoke config under ``mode`` (ERK 0.8,
    seed 0; block-aligned masks in 16x16 blocks for every mode, so one
    topology serves all three) and the reference's dense twin config."""
    if mode not in _STATES:
        cfg = configure_kernel(t_get_config(ARCH, smoke=True), kernel="block_sparse",
                               block=BLOCK)
        params, masks, pack = init_serving_state(cfg, seed=0, device="cpu")
        if mode != "block_sparse":
            cfg = configure_kernel(cfg, kernel=mode)
            pack = None
        _STATES[mode] = (cfg, params, masks, pack)
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               sparse=SparseConfig(sparsity=0.8, kernel="dense"))
    return jcfg, _STATES[mode]


# --------------------------------------------------------------------------
# config, init, ERK, packs
# --------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for smoke in (False, True):
        assert (dataclasses.asdict(t_get_config(ARCH, smoke=smoke))
                == dataclasses.asdict(get_config(ARCH, smoke=smoke)))
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.slstm_every) == (48, 2048, 4, 8)
    assert tm.padded_vocab(full) == 50432 and full.tie_embeddings


def _reference_shapes(cfg):
    box = {}

    def init(key):
        params, _, flags = j_init_lm(key, cfg)
        box["flags"] = flags
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return j_tree_paths(shapes), j_tree_paths(box["flags"])


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """Paths, shapes and sparse flags of the reference's tree (no ``head``:
    tied; ``layers/i/slstm/r`` a bare (nh, hd, 4 hd) leaf), and the same
    ERK map over them.  The full config is checked on shapes alone."""
    sp = SparseConfig(sparsity=0.8, distribution="erk")
    jcfg = dataclasses.replace(get_config(ARCH, smoke=smoke), sparse=sp)
    tcfg = t_get_config(ARCH, smoke=smoke)
    shapes, flags = _reference_shapes(jcfg)
    assert "head/w" not in shapes and "layers/1/slstm/r" in shapes if smoke else True
    if smoke:
        tp, tf = tm.init_lm(tcfg, device="cpu")
        got = tree_paths(tp)
        assert sorted(got) == sorted(shapes)
        for n, s in shapes.items():
            assert tuple(got[n].shape) == tuple(s.shape), n
        assert tree_paths(tf) == {n: bool(v) for n, v in flags.items()}
        assert got["layers/1/slstm/r"].dim() == 3
    want = j_sparsity_map(jcfg, shapes, flags)
    got = sparsity_map(tcfg, shapes, flags)
    assert got.keys() == want.keys()
    assert any(n.endswith("slstm/r") for n in got)
    for n in want:
        assert got[n] == pytest.approx(want[n], abs=1e-12), n


def test_packs_cover_xlstm_and_match_reference():
    """Every mask leaf of the mLSTM and sLSTM blocks gets an entry, ``r``
    a grouped one (per-head CSC/CSR at one width), equal to the
    reference's ``build_pack_state`` on the same masks."""
    _, (cfg, params, masks, pack) = _state("block_sparse")
    got = bridge.pack_flat_of(pack)
    assert sorted(got) == sorted(tree_paths(masks))
    assert got["layers/1/slstm/r"]["idx"].ndim == 3
    assert any("/mlstm/" in n for n in got)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jpack.build_pack_state(_jx(masks), (BLOCK, BLOCK)), is_leaf=jpack.is_pack_entry)
    from repro.core.masks import path_name
    want = {path_name(p): e for p, e in jflat if e is not None}
    assert sorted(want) == sorted(got)
    for n, e in want.items():
        for k in ("idx", "cnt", "ridx", "rcnt"):
            assert np.array_equal(got[n][k], np.asarray(e[k])), (n, k)
        assert got[n]["nnz"] == int(e["nnz"])


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def _block_params(key):
    """Layer 0 (mLSTM) or 1 (sLSTM) of the dense serve state."""
    _, (cfg, params, _, _) = _state("dense")
    lp = params["layers"][0 if key == "mlstm" else 1][key]
    return cfg, lp


def _grads(fn_t, fn_j, p, x, S_out_seed=9):
    """Forward outputs and the gradients of <out, cotangent> + sum of the
    final state, w.r.t. x and every param leaf, on both sides."""
    leaves = tree_paths(p)
    tp = tree_map(lambda _, t: t.detach().clone().requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, st = fn_t(tp, tx)
    cot = np.random.default_rng(S_out_seed).standard_normal(out.shape).astype(np.float32)

    def jloss(jp, jx_):
        o, s = fn_j(jp, jx_)
        return jnp.sum(o * cot) + sum(jnp.sum(v) for k, v in s.items() if k != "m")

    jo, js = jax.jit(fn_j)(_jx(p), jnp.asarray(x))
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jx(p), jnp.asarray(x))
    loss = (out * torch.from_numpy(cot)).sum() + sum(v.sum() for k, v in st.items()
                                                     if k != "m")
    tleaves = tree_paths(tp)
    g = torch.autograd.grad(loss, [tx] + [tleaves[n] for n in leaves])
    return (out, st, g[0], dict(zip(leaves, g[1:]))), (jo, js, jg_x, j_tree_paths(jg_p))


def test_mlstm_chunks_state_and_grads_match_reference():
    """S = 150 over q_chunk 64 as two calls, the second from the first's
    state: chunks of 64 and 36, then 50 from the carried (C, n, m)."""
    cfg, p = _block_params("mlstm")
    x = np.random.default_rng(1).standard_normal((2, 150, cfg.d_model)).astype(np.float32)
    split = 100

    def run_t(pp, xx):
        o1, s1 = X.mlstm(pp, xx[:, :split], cfg, chunk=cfg.q_chunk)
        o2, s2 = X.mlstm(pp, xx[:, split:], cfg, chunk=cfg.q_chunk, state=s1)
        return torch.cat([o1, o2], 1), s2

    def run_j(pp, xx):
        o1, s1 = jX.mlstm(pp, xx[:, :split], cfg, chunk=cfg.q_chunk)
        o2, s2 = jX.mlstm(pp, xx[:, split:], cfg, chunk=cfg.q_chunk, state=s1)
        return jnp.concatenate([o1, o2], 1), s2

    (o, st, gx, gp), (jo, js, jgx, jgp) = _grads(run_t, run_j, p, x)
    _close(o, jo, "mlstm out")
    for k in ("C", "n", "m"):
        _close(st[k], js[k], f"state {k}")
    _close(gx, jgx, "grad x")
    for n, g in gp.items():
        _close(g, jgp[n], f"grad {n}")


def test_slstm_and_grads_match_reference():
    cfg, p = _block_params("slstm")
    x = np.random.default_rng(2).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    (o, st, gx, gp), (jo, js, jgx, jgp) = _grads(
        lambda pp, xx: X.slstm(pp, xx, cfg), lambda pp, xx: jX.slstm(pp, xx, cfg), p, x)
    _close(o, jo, "slstm out")
    for k in ("c", "n", "h", "m"):
        _close(st[k], js[k], f"state {k}")
    _close(gx, jgx, "grad x")
    for n, g in gp.items():
        _close(g, jgp[n], f"grad {n}")


@pytest.mark.parametrize("key", ["mlstm", "slstm"])
def test_decode_steps_match_full_forward(key):
    """Stepping ``*_decode`` token by token from the initial state gives the
    full forward's outputs and final state (the mLSTM's over chunks of 8)."""
    cfg, p = _block_params(key)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        if key == "mlstm":
            full, fst = X.mlstm(p, x, cfg, chunk=8)
            st, step = X.init_mlstm_state(cfg, 2, "cpu"), X.mlstm_decode
        else:
            full, fst = X.slstm(p, x, cfg)
            st, step = X.init_slstm_state(cfg, 2, "cpu"), X.slstm_decode
        outs = []
        for t in range(x.shape[1]):
            o, st = step(p, x[:, t:t + 1], st, cfg)
            outs.append(o)
    _close(torch.cat(outs, 1), full.numpy(), f"{key} decode outputs")
    for k, v in fst.items():
        _close(st[k], v.numpy(), f"{key} decode state {k}")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _batch(seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (B, S)).astype(np.int32),
            rng.integers(0, 128, (B, S)).astype(np.int32))


_REF = {}


def _ref(key, fn):
    """The reference's result for ``key``, computed once: the masked and
    block-sparse modes share one topology, so one reference run (w * m)
    serves both."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_and_grads_match_reference(mode):
    """The loss and the gradient of every leaf, the tied table's (the
    gather's and the head's summed) and ``r``'s included.  The kernel modes'
    weight gradients are the masked ones, zero outside the mask."""
    jcfg, (cfg, params, masks, pack) = _state(mode)
    toks, tgt = _batch(5)
    # dense: the pre-masked weights without masks on both sides (the dense
    # gradient); the kernel modes against the reference's w * m
    jm = None if mode == "dense" else _jx(masks)
    want, jg = _ref(("loss", mode == "dense"), lambda: jax.jit(jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, {"tokens": jnp.asarray(toks),
                                      "targets": jnp.asarray(tgt)}, masks=jm)))(
        _jx(params)))
    jg = j_tree_paths(jg)
    leaves = tree_paths(params)
    tp = tree_map(lambda _, t: t.clone().requires_grad_(True), params)
    loss = tm.lm_loss(tp, cfg, {"tokens": torch.from_numpy(toks).long(),
                                "targets": torch.from_numpy(tgt).long()},
                      masks=None if mode == "dense" else masks, pack=pack)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    tl = tree_paths(tp)
    grads = dict(zip(leaves, torch.autograd.grad(loss, [tl[n] for n in leaves])))
    mflat = tree_paths(masks)
    assert "embed/table" in grads and "layers/1/slstm/r" in grads
    for n, g in grads.items():
        _close(g, jg[n], f"{mode} grad {n}")
        if n in mflat and mode != "dense":
            assert float(g[~mflat[n]].abs().max()) == 0.0, n


@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_prefill_decode_match_reference_and_freeze_inactive(mode):
    """Two slots admitted (two 9-token prompts) into shared states, then 3
    decode steps, slot 0 inactive for the last two: logits against the
    reference's ``lm_prefill_into``/``lm_decode``; the inactive slot's
    states bit for bit unchanged, the active slot's against the
    reference's."""
    jcfg, (cfg, params, masks, pack) = _state(mode)
    w = tm.serving_weights(params, cfg)
    max_len = 32
    prompts = [np.random.default_rng(20 + s).integers(0, 128, (1, L)).astype(np.int32)
               for s, L in enumerate((9, 9))]
    actives = [np.array([step < 1, True]) for step in range(3)]

    def reference():
        """The reference's prefill logits and, per decode step, (logits,
        caches) with the greedy tokens fed back."""
        jp, jm = _jx(params), _jx(masks)
        jc = j_init_caches(jcfg, 2, max_len)
        j_into = jax.jit(lambda c, t, slot: j_lm_prefill_into(
            jp, jcfg, c, {"tokens": t}, slot, max_len, masks=jm))
        j_dec = jax.jit(lambda c, t, act: j_lm_decode(jp, jcfg, c, t, 0, masks=jm,
                                                      active=act))
        pre = []
        for slot, prompt in enumerate(prompts):
            jl, jc = j_into(jc, jnp.asarray(prompt), slot)
            pre.append(np.asarray(jl))
        cur = np.array([int(np.argmax(jl[0, -1])) for jl in pre])
        steps = []
        for active in actives:
            jl, jc = j_dec(jc, jnp.asarray(cur)[:, None], jnp.asarray(active))
            steps.append((cur, np.asarray(jl), jax.tree_util.tree_map(np.asarray, jc)))
            cur = np.where(active, np.argmax(np.asarray(jl)[:, -1], -1), cur)
        return pre, steps

    pre, steps = _ref("serve", reference)
    tc = tm.init_caches(cfg, 2, max_len, "cpu")
    for slot, (prompt, jl) in enumerate(zip(prompts, pre)):
        tl, tc = tm.lm_prefill_into(w, cfg, tc, {"tokens": torch.from_numpy(prompt).long()},
                                    slot, max_len, masks=masks, pack=pack)
        _close(tl[..., :128], jl[..., :128], f"prefill {slot}")
        assert (tl[..., 128:] == -1e30).all()
    for step, (active, (cur, jl, jc)) in enumerate(zip(actives, steps)):
        frozen = [{k: v.clone() for k, v in next(iter(c.values())).items()} for c in tc]
        tl, tc = tm.lm_decode(w, cfg, tc, torch.from_numpy(cur)[:, None].long(), 0,
                              masks=masks, pack=pack, active=torch.from_numpy(active))
        _close(tl[active], jl[active], f"decode {step}")
        for c, f, jcl in zip(tc, frozen, jc):
            (key, st), = c.items()
            for k, v in st.items():
                if not active[0]:
                    assert torch.equal(v[0], f[k][0]), (step, key, k)
                _close(v[1], jcl[key][k][1], f"state {key}/{k}")


# one prompt length: the reference traces one prefill per exact length
REQ = dict(prompt_lens=(9,), gen_lens=(6, 4, 5))


def _drain(engine):
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


def test_engine_streams_match_reference():
    """The port engine (block_sparse) against the reference engine on the
    same weights and masks: the same requests, exact-length prefills (a
    pad step would enter the recurrent states), the same slots, equal
    greedy streams."""
    jcfg, (cfg, params, masks, pack) = _state("block_sparse")
    jreqs, treqs = j_requests(jcfg, 3, **REQ), t_requests(cfg, 3, **REQ)
    engines = {}
    for name, Engine, c, p, m, k, reqs in (
            ("jax", JEngine, jcfg, _jx(params), _jx(masks), None, jreqs),
            ("port", TEngine, cfg, params, masks, pack, treqs)):
        engines[name] = Engine(c, p, capacity=2, max_len=24, masks=m, pack=k)
        for r in reqs:
            assert engines[name].submit(r)
        _drain(engines[name])
    assert engines["port"]._padded_len(9) == 9
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.status is Status.DONE for r in treqs)
    assert engines["port"].slot_history == engines["jax"].slot_history


@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_paged_engine_matches_contiguous(mode):
    """A paged xLSTM engine has no KV pool (its states stay slot-batched)
    and streams the contiguous engine's tokens."""
    _, (cfg, params, masks, pack) = _state(mode)
    streams = []
    for paged in (False, True):
        engine = TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                         paged=paged, page_size=8)
        assert engine.pools == {}
        reqs = t_requests(cfg, 4, prompt_lens=(6, 11), gen_lens=(5, 7))
        for r in reqs:
            engine.submit(r)
        _drain(engine)
        assert all(r.status is Status.DONE for r in reqs)
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]


def test_prefix_cache_refused_for_xlstm():
    _, (cfg, params, masks, pack) = _state("block_sparse")
    with pytest.raises(ValueError, match="recurrent state"):
        TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                paged=True, prefix_cache=2)


# --------------------------------------------------------------------------
# the recurrent bank through the grouped kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_recurrent_bank_one_grouped_call_per_step(monkeypatch, mode):
    """The sLSTM runs ``r`` through the grouped wrapper once per time step
    (and once per decode step), the head dim leading: (nh, B, hd)."""
    _, (cfg, params, masks, pack) = _state(mode)
    calls = []
    name = "grouped_block_sparse_linear" if mode == "block_sparse" else \
        "grouped_masked_linear"
    real = getattr(X.grouped_linear.__globals__[name], "__wrapped__",
                   X.grouped_linear.__globals__[name])

    def count(x, w, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, w, *a, **kw)

    monkeypatch.setitem(X.grouped_linear.__globals__, name, count)
    toks = torch.from_numpy(_batch(6, B=3, S=9)[0]).long()
    with torch.no_grad():
        _, caches = tm.lm_prefill(params, cfg, {"tokens": toks}, 16, masks=masks, pack=pack)
        n_slstm = sum(cfg.is_slstm(i) for i in range(cfg.n_layers))
        assert calls == [(cfg.n_heads, 3, cfg.d_model // cfg.n_heads)] * (9 * n_slstm)
        calls.clear()
        tm.lm_decode(params, cfg, caches, toks[:, :1], 9, masks=masks, pack=pack)
    assert len(calls) == n_slstm


@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_recurrent_bank_matches_reference_kernel(mode):
    """One grouped call on layer 1's ``r`` (2 heads, 32 -> 128, 16-block
    ERK mask) at the step's layout (nh, B, hd): the port's wrapper (its
    plain version here) against the reference's grouped Pallas kernel in
    interpret mode."""
    _, (cfg, params, masks, pack) = _state(mode)
    r, m = params["layers"][1]["slstm"]["r"], masks["layers"][1]["slstm"]["r"]
    h = np.random.default_rng(7).standard_normal((cfg.n_heads, 3, r.shape[1])).astype(
        np.float32)
    th = torch.from_numpy(h)
    if mode == "block_sparse":
        e = pack["layers"][1]["slstm"]["r"]
        got = tops.grouped_block_sparse_linear(th, r, pack=e, block=(128, BLOCK, BLOCK))
        jentry = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
                  for k, v in e.items()}
        want = jops.grouped_block_sparse_linear(jnp.asarray(h), jnp.asarray(r.numpy()),
                                                block=(128, BLOCK, BLOCK), pack=jentry)
    else:
        got = tops.grouped_masked_linear(th, r, m, block=(128, BLOCK, BLOCK))
        want = jops.grouped_masked_linear(jnp.asarray(h), jnp.asarray(r.numpy()),
                                          jnp.asarray(m.numpy()), block=(128, BLOCK, BLOCK))
    _close(got, want, f"{mode} r bank", tol=1e-6)


def test_serve_and_train_clis_run_xlstm(tmp_path):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import train_loop
    stats = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kernel",
                        "block_sparse", "--block", str(BLOCK), "--requests", "3"])
    assert stats["requests"] == 3 and stats["failed"] == 0
    cfg = configure_kernel(t_get_config(ARCH, smoke=True), kernel="block_sparse",
                           block=BLOCK)
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, delta_t=2,
                                                              alpha=0.9))
    state, log = train_loop(cfg, steps=4, batch=2, seq=16, workdir=str(tmp_path),
                            device="cpu", ckpt_every=None, log_every=4)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tpack.validate_pack(state["pack"]) == len(tree_paths(state["masks"]))
    assert int(tpack.pack_mismatch(state["masks"], state["pack"], (BLOCK, BLOCK),
                                   bwd_masks=state["bwd_masks"])) == 0
