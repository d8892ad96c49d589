"""Port model vs the JAX package on the bridged smoke state: lm_prefill
logits and caches, and per-slot lm_decode with an active mask.

The JAX side runs kernel='block_sparse' (block 16, Pallas interpret mode)
and attn_kernel='flash_tight'; the port runs the plain versions of its
kernels on the CPU.  Both get the same params, masks and pack.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_prefill as j_lm_prefill  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(16, 16), kernel_block=(128, 16, 16),
              attn_kernel="flash_tight")
# Relative to the largest magnitude compared.  f32: the same arithmetic
# summed in another order.  bf16: both packages now run the same dtypes
# (attention projections and K/V in bf16, the residual stream, MLP and LM
# head in f32); what differs is where the attention's sums round, so a bf16
# q/k/v or p lands one ulp apart here and there.  Measured at most 2.5e-3
# on the logits and 8.1e-3 on the bf16 K/V caches (two ulps at their
# largest magnitude); the tolerances are about twice the logits' and 1.25
# times the caches' (they were 2e-2 for both while the port ran the MLP in
# bf16).
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def states(request):
    dtype = request.param
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype=dtype, sparse=SparseConfig(**SPARSE))
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               dtype=dtype, sparse=TSparse(**SPARSE))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    tmasks = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu")
    tpack = bridge.pack_from_flat(
        {path_name(p): e for p, e in flat_k if e is not None}, tp, "cpu")
    return dtype, (jcfg, st["params"], st["masks"], st["pack"]), (tcfg, tp, tmasks, tpack)


def _close(got, want, dtype, what, tols=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = tols[dtype] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |port - jax| = {err} > {tol}"


def _close_logits(got, want, cfg, dtype, what):
    """Real vocab slots within tolerance; the padding slots are the finite
    -1e30 mask in both."""
    V = cfg.vocab_size
    want = np.asarray(want, np.float32)
    _close(got[..., :V], want[..., :V], dtype, what)
    assert (got[..., V:] == -1e30).all() and (want[..., V:] == np.float32(-1e30)).all()


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S,n_valid", [(24, None), (32, 21)])
def test_prefill_matches_jax(states, S, n_valid):
    """S=24 overfills the 16-slot ring; S=32 with n_valid=21 is a bucketed
    prompt whose padding must not clobber the ring."""
    dtype, (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tpack) = states
    toks = _tokens(2, S, jcfg.vocab_size, S)
    jl, jc = jax.jit(lambda p, m, k, t: j_lm_prefill(
        p, jcfg, {"tokens": t}, max_len=40, masks=m, pack=k, n_valid=n_valid,
    ))(jp, jm, jk, jnp.asarray(toks))
    tl, tc = tm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                           40, masks=tmasks, pack=tpack, n_valid=n_valid)
    _close_logits(tl, jl, tcfg, dtype, "logits")
    for i, (a, b) in enumerate(zip(tc, jc)):
        for name in ("k", "v"):
            _close(a["kv"][name], b["kv"][name], dtype, f"layer {i} {name}", CACHE_TOL)


def test_per_slot_decode_matches_jax(states):
    """Two slots admitted with prompts 10 and 20 into shared caches, then 4
    per-slot decode steps; slot 0 goes inactive for the last two, so its
    cache row must stay untouched."""
    dtype, (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tpack) = states
    max_len = 40
    jc = j_init_caches(jcfg, 2, max_len)
    tc = tm.init_caches(tcfg, 2, max_len, "cpu")
    lens = (10, 20)
    tok = []
    j_prefill_into = jax.jit(lambda p, m, k, c, t, slot: j_lm_prefill_into(
        p, jcfg, c, {"tokens": t}, slot, max_len, masks=m, pack=k))
    j_decode = jax.jit(lambda p, m, k, c, t, pos, act: j_lm_decode(
        p, jcfg, c, t, pos, masks=m, pack=k, active=act))
    for slot, L in enumerate(lens):
        p = _tokens(1, L, jcfg.vocab_size, 100 + slot)
        jl, jc = j_prefill_into(jp, jm, jk, jc, jnp.asarray(p), jnp.int32(slot))
        tl, tc = tm.lm_prefill_into(tp, tcfg, tc, {"tokens": torch.from_numpy(p).long()},
                                    slot, max_len, masks=tmasks, pack=tpack)
        _close_logits(tl, jl, tcfg, dtype, f"prefill slot {slot}")
        tok.append(int(np.argmax(np.asarray(jl)[0, -1])))
    tok = np.asarray(tok, np.int32)
    pos = np.asarray(lens, np.int32)
    for step in range(4):
        active = np.asarray([step < 2, True])
        jl, jc = j_decode(jp, jm, jk, jc, jnp.asarray(tok[:, None]),
                          jnp.asarray(pos), jnp.asarray(active))
        tl, tc = tm.lm_decode(tp, tcfg, tc, torch.from_numpy(tok[:, None]).long(),
                              torch.from_numpy(pos).long(), masks=tmasks, pack=tpack,
                              active=torch.from_numpy(active))
        _close_logits(tl[active], np.asarray(jl)[active], tcfg, dtype,
                      f"decode step {step}")
        for i, (a, b) in enumerate(zip(tc, jc)):
            for name in ("k", "v"):
                _close(a["kv"][name], b["kv"][name], dtype,
                       f"step {step} layer {i} {name}", CACHE_TOL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
        tok = np.where(active, nxt, tok)
        pos = pos + active


def test_scalar_decode_matches_jax(states):
    """The lockstep form: one shared position for every row."""
    dtype, (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tpack) = states
    toks = _tokens(2, 18, jcfg.vocab_size, 7)
    _, jc = jax.jit(lambda p, m, k, t: j_lm_prefill(
        p, jcfg, {"tokens": t}, max_len=24, masks=m, pack=k))(jp, jm, jk, jnp.asarray(toks))
    _, tc = tm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, 24,
                          masks=tmasks, pack=tpack)
    nxt = toks[:, -1:]
    jl, _ = jax.jit(lambda p, m, k, c, t: j_lm_decode(
        p, jcfg, c, t, 18, masks=m, pack=k))(jp, jm, jk, jc, jnp.asarray(nxt))
    tl, _ = tm.lm_decode(tp, tcfg, tc, torch.from_numpy(nxt).long(), 18,
                         masks=tmasks, pack=tpack)
    _close_logits(tl, jl, tcfg, dtype, "scalar-pos decode")


def test_dense_mode_prefill_matches_jax(states):
    """kernel='dense' / attn_kernel='dense': masked weights as plain
    matmuls and the plain masked softmax, on both sides."""
    dtype, (jcfg, jp, jm, _), (tcfg, tp, tmasks, _) = states
    sp = dict(kernel="dense", attn_kernel="dense")
    jcfg = dataclasses.replace(jcfg, sparse=dataclasses.replace(jcfg.sparse, **sp))
    tcfg = dataclasses.replace(tcfg, sparse=dataclasses.replace(tcfg.sparse, **sp))
    toks = _tokens(2, 20, jcfg.vocab_size, 11)
    jl, _ = jax.jit(lambda p, m, t: j_lm_prefill(
        p, jcfg, {"tokens": t}, max_len=24, masks=m))(jp, jm, jnp.asarray(toks))
    tl, _ = tm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, 24,
                          masks=tmasks)
    _close_logits(tl, jl, tcfg, dtype, "dense-mode prefill")


def test_mlp_runs_in_the_reference_dtype(states, monkeypatch):
    """The reference's MLP runs in the f32 residual's dtype even under a
    bf16 config (NumPy's float64 sqrt(d_model) promotes the embedding), in
    prefill and in decode; the port's MLP takes and returns the same
    dtypes, layer by layer."""
    import repro.models.model as j_model

    dtype, (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tpack) = states
    seen = {"jax": [], "port": []}

    def recorder(fn, key):
        def rec(p, x, *a, **kw):
            y = fn(p, x, *a, **kw)
            seen[key].append((str(x.dtype).removeprefix("torch."),
                              str(y.dtype).removeprefix("torch.")))
            return y
        return rec

    monkeypatch.setattr(j_model, "mlp", recorder(j_model.mlp, "jax"))
    monkeypatch.setattr(tm, "mlp", recorder(tm.mlp, "port"))
    toks = _tokens(1, 16, jcfg.vocab_size, 3)
    jax.eval_shape(lambda p, m, k, t: j_lm_decode(
        p, jcfg, j_lm_prefill(p, jcfg, {"tokens": t}, max_len=24, masks=m, pack=k)[1],
        t[:, -1:], 16, masks=m, pack=k), jp, jm, jk, jnp.asarray(toks))
    _, caches = tm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, 24,
                              masks=tmasks, pack=tpack)
    tm.lm_decode(tp, tcfg, caches, torch.from_numpy(toks[:, -1:]).long(), 16,
                 masks=tmasks, pack=tpack)
    assert seen["jax"] == [("float32", "float32")] * (2 * jcfg.n_layers)
    assert seen["port"] == seen["jax"]
