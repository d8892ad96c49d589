"""Port paged serving vs the JAX package: BlockPool decisions, the pool
primitives, the paged-prefix flash phase (K12's plain version), suffix-only
prefill, and the paged engine with the copy-on-write prefix cache.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the plain versions of its kernels.  Both get the same numpy-seeded
inputs or the same bridged state.  Tolerances are relative to the largest
magnitude compared: f32 1e-5 (the same arithmetic in another order of
sums); bf16 1e-2 on the attention output (one bf16 rounding of o on each
side plus the kernel's bf16 p, against the port's plain f32 p) and 5e-3 on
the logits and written K/V pages (the slice-1 tolerance of the bf16 model).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.attn_sched import paged_prefix_schedule as j_sched  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.kernels.flash_attention import flash_attention_paged as j_paged  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import init_paged_caches as j_init_paged  # noqa: E402
from repro.models import lm_prefill_into as j_prefill_into  # noqa: E402
from repro.models import lm_prefill_suffix as j_prefill_suffix  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving.block_pool import BlockPool as JPool  # noqa: E402
from repro.serving.queue import Request as JRequest  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.attn_sched import paged_prefix_schedule as t_sched  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import init_serving_state, main  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.block_pool import BlockPool as TPool  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Request as TRequest  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

pytestmark = pytest.mark.paged

SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(16, 16), kernel_block=(128, 16, 16),
              attn_kernel="flash_tight")
PAGE = 4


def _close(got, want, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _bridged(arch, dtype):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                               sparse=SparseConfig(**SPARSE))
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype,
                               sparse=TSparse(**SPARSE))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    tmask = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu")
    tpack = bridge.pack_from_flat(
        {path_name(p): e for p, e in flat_k if e is not None}, tp, "cpu")
    return (jcfg, st["params"], st["masks"], st["pack"]), (tcfg, tp, tmask, tpack)


@pytest.fixture(scope="module")
def mistral_f32():
    return _bridged("mistral-large-123b", "float32")


# ---------------------------------------------------------------------------
# host state: BlockPool and the paged-prefix schedule
# ---------------------------------------------------------------------------

def _pool_ops(seed, n_ops=200, n_blocks=12):
    """A random op sequence over (alloc n | incref held page | free held
    page | fork shared page), with invalid ops mixed in."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(4)), int(rng.integers(1, 4)), int(rng.integers(1 << 30)))
            for _ in range(n_ops)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_matches_reference_op_for_op(seed):
    pools = {"jax": JPool(12, PAGE), "port": TPool(12, PAGE)}
    held = {k: [] for k in pools}  # one entry per outstanding reference
    for op, n, pick in _pool_ops(seed):
        res = {}
        for name, pool in pools.items():
            h = held[name]
            try:
                if op == 0:
                    got = pool.alloc(n)
                    h.extend(got)
                elif op == 1:
                    page = h[pick % len(h)] if h else pick % 13
                    pool.incref([page])
                    h.append(page)
                    got = page
                elif op == 2:
                    page = h.pop(pick % len(h)) if h else pick % 13
                    pool.free([page])
                    got = page
                else:
                    page = h[pick % len(h)] if h else pick % 13
                    got = pool.fork(page)
                    h.remove(page)
                    h.append(got)
            except (MemoryError, ValueError) as e:
                got = type(e).__name__
            res[name] = got
            pool.check(h)
        assert res["port"] == res["jax"]
        a, b = pools["jax"], pools["port"]
        assert b._free == a._free and (b.refcount == a.refcount).all()
        assert (b.n_forks, b.n_free, b.n_live) == (a.n_forks, a.n_free, a.n_live)
    assert pools["port"].n_forks > 0


def test_paged_prefix_schedule_matches_reference():
    for args in ((5, 6, 16, 8), (128, 256, 128, 16), (300, 3, 128, 4)):
        a, b = j_sched(*args), t_sched(*args)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# pool primitives with sentinel entries
# ---------------------------------------------------------------------------

N_BLK, KVH, HD = 10, 2, 16


def _pool_np(rng):
    return {n: rng.standard_normal((N_BLK, PAGE, KVH, HD)).astype(np.float32)
            for n in ("k", "v")}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_gather_and_fill_kv_pool_match_reference():
    rng = np.random.default_rng(0)
    pool = _pool_np(rng)
    table = np.array([[3, 7, N_BLK, N_BLK], [N_BLK, 9, 0, 1]], np.int32)
    jv = JA.gather_kv_pool({n: jnp.asarray(x) for n, x in pool.items()},
                           jnp.asarray(table))
    tv = TA.gather_kv_pool({n: _t(x) for n, x in pool.items()}, _t(table))
    for n in ("k", "v"):
        np.testing.assert_array_equal(tv[n].numpy(), np.asarray(jv[n]))
    # a row of 4 pages into a partly allocated table (the sentinel drops,
    # page N - 1 is owned so a clamped drop must not clobber it)
    row = {n: rng.standard_normal((1, 4 * PAGE, KVH, HD)).astype(np.float32)
           for n in ("k", "v")}
    for tab in ([2, N_BLK - 1, N_BLK, N_BLK], [N_BLK, N_BLK, 5, N_BLK - 1]):
        tab = np.array(tab, np.int32)
        jp = JA.fill_kv_pool({n: jnp.asarray(x) for n, x in pool.items()},
                             {n: jnp.asarray(x) for n, x in row.items()},
                             jnp.asarray(tab))
        tp = TA.fill_kv_pool({n: _t(x) for n, x in pool.items()},
                             {n: _t(x) for n, x in row.items()}, _t(tab))
        for n in ("k", "v"):
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]))


@pytest.mark.parametrize("start,n_valid", [(0, 7), (5, 7), (9, 3), (13, 8)])
def test_fill_kv_pool_suffix_matches_reference(start, n_valid):
    """Suffix writes from a page-unaligned start, bucket padding dropped,
    positions past the table's owned pages (sentinel) dropped."""
    rng = np.random.default_rng(start)
    pool = _pool_np(rng)
    table = np.array([4, 8, 2, 6, N_BLK, N_BLK], np.int32)
    k, v = (rng.standard_normal((1, 8, KVH, HD)).astype(np.float32) for _ in range(2))
    jp = JA.fill_kv_pool_suffix({n: jnp.asarray(x) for n, x in pool.items()},
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(table), jnp.int32(start),
                                jnp.int32(n_valid))
    tp = TA.fill_kv_pool_suffix({n: _t(x) for n, x in pool.items()}, _t(k),
                                _t(v), _t(table), start, n_valid)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]))


# ---------------------------------------------------------------------------
# the paged-prefix phase: K12's plain version vs the reference kernel
# ---------------------------------------------------------------------------

def _paged_inputs(seed, *, B, H, KV, Sq, d, N, T, ctx, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, d)).astype(np.float32)
    pk, pv = (rng.standard_normal((N, PAGE, KV, d)).astype(np.float32)
              for _ in range(2))
    table = np.full((B, T), N, np.int32)
    perm = rng.permutation(N)
    for b, c in enumerate(ctx):
        n = -(-c // PAGE)
        table[b, :n] = perm[:n]
        perm = np.roll(perm, -n)
    arrs = (q, pk, pv)
    j = [jnp.asarray(a, dtype) for a in arrs]
    t = [_t(a).to(getattr(torch, dtype)) for a in arrs]
    ctx = np.asarray(ctx, np.int32)
    return (j + [jnp.asarray(table), jnp.asarray(ctx)],
            t + [_t(table), _t(ctx)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,softcap", [(1, 0.0), (3, 0.0), (3, 5.0)])
def test_paged_flash_plain_matches_reference_kernel(dtype, G, softcap):
    """ctx 0 (no live key), inside a page, full pages, up to the whole
    table; GQA folded (G query heads per KV head) and the softcap."""
    KV, T = 2, 6
    ctx = [0, 6, 4 * PAGE, T * PAGE]
    jin, tin = _paged_inputs(G, B=4, H=KV * G, KV=KV, Sq=5, d=16, N=24, T=T,
                             ctx=ctx, dtype=dtype)
    jo, jl = j_paged(*jin, bq=16, softcap=softcap)
    to, tl = tfa.flash_attention_paged(*tin, softcap=softcap)
    assert to.dtype == tin[0].dtype and tl.dtype == torch.float32
    _close(to, jo, 1e-5 if dtype == "float32" else 1e-2, "o")
    jl = np.asarray(jl)
    live = jl > -1e29
    assert (tl.numpy()[~live] == np.float32(-1e30)).all()
    assert (~live).sum() == KV * G * 5  # exactly the ctx = 0 row
    np.testing.assert_allclose(tl.numpy()[live], jl[live], rtol=1e-5)
    assert (to[0] == 0).all()


@pytest.mark.parametrize("flash", [False, True])
def test_attend_with_history_matches_reference(flash):
    """Suffix attention over [paged prefix, causal self], f32: the dense
    branch (one masked softmax) and the flash branch (K12 + K9 merged by
    logsumexp, with a ctx = 0 row whose prefix weight must vanish)."""
    cfg = dataclasses.replace(get_config("mistral-large-123b", smoke=True),
                              dtype="float32")
    tcfg = dataclasses.replace(t_get_config("mistral-large-123b", smoke=True),
                               dtype="float32")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(7)
    B, S, T, N = 2, 6, 5, 12
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32) for _ in range(2))
    pool = {n: rng.standard_normal((N, PAGE, KV, hd)).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[5, 1, 9, N, N], [2, N, N, N, N]], np.int32)
    ctx = np.array([10, 0], np.int32)
    jo = JA._attend_with_history(
        *(jnp.asarray(a) for a in (q, k, v)),
        {"pool": {n: jnp.asarray(x) for n, x in pool.items()},
         "table": jnp.asarray(table), "ctx": jnp.asarray(ctx)}, cfg, flash=flash)
    to = TA._attend_with_history(
        *(_t(a) for a in (q, k, v)),
        {"pool": {n: _t(x) for n, x in pool.items()}, "table": _t(table),
         "ctx": _t(ctx)}, tcfg, flash=flash)
    _close(to, jo, 1e-5, "o")


# ---------------------------------------------------------------------------
# model: suffix-only prefill on mistral-large SMOKE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_suffix_matches_reference(dtype):
    """A full paged prefill of a 13-token prompt, then a suffix prefill of 7
    tokens on top of its first ctx = 10 positions (a page-unaligned
    prefix, the suffix starting inside page 2), bucketed to 8 with one pad:
    logits and every pool page against the reference."""
    jside, tside = _bridged("mistral-large-123b", dtype)
    jcfg, jp, jm, jk = jside
    tcfg, tp, tmask, tpack = tside
    tol = 1e-5 if dtype == "float32" else 5e-3
    N, max_len = 16, 32
    T = max_len // PAGE
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, 16).astype(np.int32)
    table = np.full(T, N, np.int32)
    table[:5] = [11, 3, 7, 0, 14]
    jc = j_init_paged(jcfg, 1, max_len, {"global": N}, PAGE)
    tc = tm.init_paged_caches(tcfg, {"global": N}, PAGE, "cpu")
    j_tab = {"global": jnp.asarray(table)}
    t_tab = {"global": _t(table)}
    jl, jc = jax.jit(lambda p, m, k, c, t, tab: j_prefill_into(
        p, jcfg, c, {"tokens": t}, 0, max_len, masks=m, pack=k, n_valid=13,
        tables=tab))(jp, jm, jk, jc, jnp.asarray(prompt[None]), j_tab)
    tl, tc = tm.lm_prefill_into(tp, tcfg, tc, {"tokens": _t(prompt[None]).long()},
                                0, max_len, masks=tmask, pack=tpack, n_valid=13,
                                tables=t_tab)
    _close(tl[..., :jcfg.vocab_size], np.asarray(jl)[..., :jcfg.vocab_size], tol,
           "full prefill logits")
    suffix = np.zeros(8, np.int32)
    suffix[:7] = rng.integers(0, jcfg.vocab_size, 7)
    jl, jc = jax.jit(lambda p, m, k, c, t, tab, ctx: j_prefill_suffix(
        p, jcfg, c, {"tokens": t}, tab, ctx, masks=m, pack=k, n_valid=7))(
        jp, jm, jk, jc, jnp.asarray(suffix[None]), jnp.asarray(table),
        jnp.int32(10))
    tl, tc = tm.lm_prefill_suffix(tp, tcfg, tc, {"tokens": _t(suffix[None]).long()},
                                  _t(table), 10, masks=tmask, pack=tpack, n_valid=7)
    V = jcfg.vocab_size
    _close(tl[..., :V], np.asarray(jl)[..., :V], tol, "suffix logits")
    for i, (a, b) in enumerate(zip(jc, tc)):
        for n in ("k", "v"):
            _close(b["kv"][n], a["kv"][n], tol, f"layer {i} pool {n}")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _drain(engine):
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


def _prefix_requests(Req, vocab, *, temperature=0.0, top_k=0):
    """Six requests on one 20-token template (5 pages of 4) plus 0-5
    suffix tokens: a miss, then hits with and without a boundary fork (a
    0-token suffix shares ctx = 19, inside page 4)."""
    rng = np.random.default_rng(11)
    tmpl = rng.integers(0, vocab, 20).astype(np.int32)
    out = []
    for i, (sfx, gen) in enumerate(((3, 6), (0, 4), (5, 7), (2, 3), (0, 5), (4, 2))):
        toks = np.concatenate([tmpl, rng.integers(0, vocab, sfx).astype(np.int32)])
        out.append(Req(rid=i, tokens=toks, max_new_tokens=gen,
                       share_prefix_len=20, temperature=temperature,
                       top_k=top_k, seed=100 + i))
    return out


def _prefix_engines(jside, tside, **req_kw):
    res = {}
    for name, Engine, side, Req in (("jax", JEngine, jside, JRequest),
                                    ("port", TEngine, tside, TRequest)):
        cfg, params, masks, pack = side
        eng = Engine(cfg, params, capacity=2, max_len=48, masks=masks, pack=pack,
                     paged=True, page_size=PAGE, prefix_cache=1)
        reqs = _prefix_requests(Req, cfg.vocab_size, **req_kw)
        for r in reqs:
            assert eng.submit(r)
        res[name] = (eng, _drain(eng), reqs)
    return res


def test_prefix_engine_matches_reference(mistral_f32):
    """Token streams, hits and misses, forks, slot history, final tables
    and pool books of the paged engine with the prefix cache, in f32."""
    res = _prefix_engines(*mistral_f32)
    (je, js, jr), (te, ts, tr) = res["jax"], res["port"]
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert all(r.status is Status.DONE for r in tr)
    assert (te.n_prefix_hits, te.n_prefix_misses) == (je.n_prefix_hits, je.n_prefix_misses) == (5, 1)
    assert ts["kv_forks"] == js["kv_forks"] == 2
    assert te.slot_history == je.slot_history
    for g in je.tables:
        np.testing.assert_array_equal(te.tables[g], je.tables[g])
        assert te.pools[g]._free == je.pools[g]._free
        np.testing.assert_array_equal(te.pools[g].refcount, je.pools[g].refcount)
    te.check_pool_accounting()
    for key in ("requests", "tokens", "decode_steps", "prefills", "prefix_entries",
                "pages_free", "pages_live"):
        assert ts[key] == js[key], key
    assert ts["suffix_prefills"] == 5


def test_paged_ring_engine_matches_contiguous():
    """h2o-danube SMOKE (every layer a 16-slot ring, window 16) served
    paged, with page 4 and prompts plus generations past the window:
    token-identical to the port's contiguous engine, pools drained."""
    cfg = t_get_config("h2o-danube-1.8b", smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32", sparse=TSparse(**SPARSE))
    params, masks, pack = init_serving_state(cfg, seed=0, device="cpu")
    streams = []
    for kw in ({}, {"paged": True, "page_size": PAGE}):
        eng = TEngine(cfg, params, capacity=2, max_len=32, masks=masks,
                      pack=pack, **kw)
        reqs = t_requests(cfg, 5, prompt_lens=(5, 20, 9), gen_lens=(6, 3, 9, 4))
        for r in reqs:
            eng.submit(r)
        _drain(eng)
        streams.append([r.generated for r in reqs])
        if kw:
            assert set(eng.pools) == {"local"}
            assert eng.tables["local"].shape == (2, 16 // PAGE)
            eng.check_pool_accounting()
            assert eng.pools["local"].n_free == eng.pools["local"].n_blocks
    assert streams[0] == streams[1]
    assert max(len(r.tokens) + len(r.generated) for r in reqs) > cfg.window


def test_paged_engine_geometry_and_admission_bounds(mistral_f32):
    _, (cfg, params, masks, pack) = mistral_f32
    with pytest.raises(ValueError, match="must divide"):
        TEngine(cfg, params, capacity=1, max_len=30, paged=True, page_size=4)
    with pytest.raises(ValueError, match="paged=True"):
        TEngine(cfg, params, capacity=1, max_len=32, prefix_cache=2)
    danube = t_get_config("h2o-danube-1.8b", smoke=True)
    dparams, _, _ = init_serving_state(danube, seed=0, device="cpu")
    with pytest.raises(ValueError, match="all-global"):
        TEngine(danube, dparams, capacity=1, max_len=32, paged=True,
                page_size=4, prefix_cache=1)
    eng = TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                  paged=True, page_size=PAGE, n_blocks=4)
    big = t_requests(cfg, 1, prompt_lens=(14,), gen_lens=(3,))[0]
    with pytest.raises(ValueError, match="pages"):
        eng.submit(big)
    # two requests of 4 pages each on a 4-page pool: the second is deferred
    # (re-queued) until the first releases its pages, not shed
    reqs = t_requests(cfg, 2, prompt_lens=(12,), gen_lens=(4,))
    for r in reqs:
        assert eng.submit(r)
    eng.step(now=0.0)
    assert eng.active.sum() == 1 and len(eng.queue) == 1
    _drain(eng)
    assert all(r.status is Status.DONE for r in reqs)
    eng.check_pool_accounting()


def test_serve_cli_paged_prefix_on_cpu(capsys):
    stats = main(["--arch", "mistral-large-123b", "--smoke", "--device", "cpu",
                  "--kernel", "block_sparse", "--block", "16", "--attn-kernel",
                  "flash_tight", "--requests", "3", "--max-len", "64",
                  "--capacity", "2", "--paged", "--prefix-cache", "2"])
    assert stats["requests"] == 3 and stats["pages_live"] == {"global": 0}
    assert "paged=True" in capsys.readouterr().out
