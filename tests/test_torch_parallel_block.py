"""Port parallel blocks (command-r-plus-104b) vs the JAX package on the smoke
config, block 16: the config copy; the init layout (no ``ln2``: the
attention and the FFN read the same normed input) and the ERK map;
``lm_forward``, ``lm_loss`` and its gradients (the tied table's included)
under dense, masked and block_sparse; prefill and decode; the engine's
greedy streams, contiguous and paged; the paged engine with the prefix
cache (the suffix prefill over shared pages, K12's plain version) against
the reference engine; a suffix prefill's logits against a full prefill's;
the CLIs.

The weights, masks, packs and tolerances are ``test_torch_gemma3.py``'s
(the reference's init weights carried by ``bridge``; 1e-4 relative for
f32 results, 5e-3 for the bf16 config's logits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemma3 import (  # noqa: E402
    MODES,
    TOL,
    _jx,
    _state,
    batch,
    clis_run,
    config_matches,
    drain,
    init_layout_matches,
    loss_and_grads_match,
    one_thread,  # noqa: F401  (the module fixture)
    prefill_decode_match,
)

from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving.queue import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Request as TRequest  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

ARCH = "command-r-plus-104b"
PAGE = 4


def test_config_copy_matches_reference():
    config_matches(ARCH)
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff) == (64, 12288, 96, 8, 128, 33792)
    assert full.parallel_block and full.tie_embeddings and tm.padded_vocab(full) == 256000
    assert all(tm.cache_group(full, i) == "global" for i in range(full.n_layers))


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """No ``ln2`` (and no post-norms or qk-norm scales) in any layer."""
    shapes, _ = init_layout_matches(ARCH, smoke)
    assert "head/w" not in shapes  # tied
    assert "layers/0/ln1/scale" in shapes and "layers/0/mlp/wg/w" in shapes
    assert not [n for n in shapes if "ln2" in n or "_post" in n or "_norm" in n]


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_forward_and_grads_match_reference(mode):
    loss_and_grads_match(ARCH, mode, ("layers/1/mlp/wo/w", "layers/1/ln1/scale"))


@pytest.mark.parametrize("mode,dtype,tol", [("masked", "float32", TOL),
                                            ("block_sparse", "float32", TOL),
                                            ("block_sparse", "bfloat16", 5e-3)])
def test_prefill_decode_match_reference(mode, dtype, tol):
    prefill_decode_match(ARCH, mode, dtype, tol)


REQ = dict(prompt_lens=(21, 5), gen_lens=(6, 4, 5))


def test_engine_streams_match_reference_contiguous_and_paged():
    """The reference engine against the port's, contiguous and paged (one
    global pool), on the same weights and masks (block_sparse): equal
    greedy streams and slots, every page back."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    jreqs = j_requests(jcfg, 3, **REQ)
    jeng = JEngine(jcfg, _jx(params), capacity=2, max_len=48, masks=_jx(masks))
    for r in jreqs:
        assert jeng.submit(r)
    drain(jeng)
    for paged in (False, True):
        treqs = t_requests(cfg, 3, **REQ)
        eng = TEngine(cfg, params, capacity=2, max_len=48, masks=masks, pack=pack,
                      paged=paged, page_size=8)
        for r in treqs:
            assert eng.submit(r)
        drain(eng)
        assert all(r.status is Status.DONE for r in treqs)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs], paged
        assert eng.slot_history == jeng.slot_history
        if paged:
            assert sorted(eng.pools) == ["global"]
            eng.check_pool_accounting()
            assert eng.pools["global"].n_live == 0


def _prefix_requests(Req, vocab):
    """Four requests on one 20-token template (5 pages of 4) plus 0-5
    suffix tokens: a miss, then hits with and without a boundary fork."""
    rng = np.random.default_rng(11)
    tmpl = rng.integers(0, vocab, 20).astype(np.int32)
    out = []
    for i, (sfx, gen) in enumerate(((3, 6), (0, 4), (5, 7), (2, 3))):
        toks = np.concatenate([tmpl, rng.integers(0, vocab, sfx).astype(np.int32)])
        out.append(Req(rid=i, tokens=toks, max_new_tokens=gen, share_prefix_len=20, seed=i))
    return out


def test_prefix_cache_engine_matches_reference():
    """The paged engine with the prefix cache (suffix prefills over the
    shared pages, the plain K12 and K9 merged by logsumexp) against the
    reference's: the same streams, hits, misses, forks, slots and tables,
    in f32 under block_sparse."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    res = {}
    for name, Engine, c, p, m, pk, Req in (
            ("jax", JEngine, jcfg, _jx(params), _jx(masks), None, JRequest),
            ("port", TEngine, cfg, params, masks, pack, TRequest)):
        eng = Engine(c, p, capacity=2, max_len=48, masks=m, pack=pk, paged=True,
                     page_size=PAGE, prefix_cache=1)
        reqs = _prefix_requests(Req, cfg.vocab_size)
        for r in reqs:
            assert eng.submit(r)
        res[name] = (eng, drain(eng), reqs)
    (je, js, jr), (te, ts, tr) = res["jax"], res["port"]
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert all(r.status is Status.DONE for r in tr)
    assert (te.n_prefix_hits, te.n_prefix_misses) == (je.n_prefix_hits, je.n_prefix_misses) == (3, 1)
    assert ts["kv_forks"] == js["kv_forks"] and ts["suffix_prefills"] == 3
    assert te.slot_history == je.slot_history
    for g in je.tables:
        np.testing.assert_array_equal(te.tables[g], je.tables[g])
    te.check_pool_accounting()


@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_suffix_prefill_matches_full_prefill(mode):
    """``lm_prefill_suffix`` over a 12-token prefix written by a full paged
    prefill: the same last-position logits as the full prefill of the
    whole 19-token prompt, and the suffix K/V at the same pool slots (the
    suffix pages are fresh, the prefix pages shared)."""
    _, cfg, params, masks, pack = _state(ARCH, mode)
    max_len, ctx, L = 24, 12, 19
    T = max_len // PAGE
    toks = torch.from_numpy(batch(7, cfg.vocab_size, B=1, S=L)[0]).long()
    caches = tm.init_paged_caches(cfg, {"global": 2 * T}, PAGE, "cpu")
    full_tab = torch.arange(T, dtype=torch.int32)
    sfx_tab = full_tab.clone()
    sfx_tab[ctx // PAGE:] += T
    kw = dict(masks=masks, pack=pack)
    with torch.no_grad():
        full, _ = tm.lm_prefill_into(params, cfg, caches,
                                     {"tokens": torch.nn.functional.pad(toks, (0, max_len - L))},
                                     0, max_len, n_valid=L, tables={"global": full_tab}, **kw)
        sfx, _ = tm.lm_prefill_suffix(params, cfg, caches,
                                      {"tokens": torch.nn.functional.pad(toks[:, ctx:], (0, 1))},
                                      sfx_tab, ctx, n_valid=L - ctx, **kw)
    V = cfg.vocab_size
    err = float((sfx[..., :V] - full[..., :V]).abs().max())
    assert err <= TOL * max(1.0, float(full[..., :V].abs().max())), err
    for c in caches:
        for n in ("k", "v"):
            pool = c["kv"][n].view(-1, *c["kv"][n].shape[2:])
            a = pool[torch.arange(ctx, L)]                       # the full prefill's
            b = pool[(torch.arange(ctx, L) // PAGE + T) * PAGE + torch.arange(ctx, L) % PAGE]
            assert float((a - b).abs().max()) <= TOL * max(1.0, float(a.abs().max())), n


def test_serve_and_train_clis_run_command_r(tmp_path):
    clis_run(ARCH, tmp_path, ["--kernel", "block_sparse", "--block", "16", "--attn-kernel",
                              "flash_tight", "--paged", "--prefix-cache", "2",
                              "--max-len", "64", "--capacity", "2"])
