"""The port's fault injector (``repro_torch/serving/faults.py``) and the
engine's failure edges, against the JAX package's.

The injector is a copy: the same seed plans the same faults and logs the
same tuples; ``burst_storm`` makes the same requests; ``truncate_pack``
corrupts the same entry the same way, and the port's ``validate_pack``
rejects every corruption.  On the same bridged weights and requests, under
a virtual clock, the port's engine quarantines the same (step, rid, slot,
attempt, phase) as the reference's, and every request it does not fail
finishes with the fault-free stream.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.serving import FaultInjector as JInjector  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import burst_storm as j_storm  # noqa: E402
from repro.serving import truncate_pack as j_truncate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.pack import PackIntegrityError, validate_pack  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.faults import FaultInjector as TInjector  # noqa: E402
from repro_torch.serving.faults import burst_storm as t_storm  # noqa: E402
from repro_torch.serving.faults import truncate_pack as t_truncate  # noqa: E402
from repro_torch.serving.queue import Request, Status  # noqa: E402

BLOCK = 16


# ---------------------------------------------------------------------------
# the injector, the storm and the pack corruptions
# ---------------------------------------------------------------------------


def _plan(Inj, seed):
    inj = Inj(seed=seed)
    pairs = inj.poison_random(5, max_step=12, capacity=3)
    inj.poison_logits(3, 2, float("inf")).poison_logits(40, 7)  # 7: off capacity
    inj.poison_prefill(4).delay_prefill(1, 0.25)
    faults = [inj.decode_fault(s, 3) for s in range(45)]
    prefill = [inj.prefill_fault(r, a) for r, a in ((4, 0), (4, 1), (2, 0))]
    return pairs, faults, prefill, [inj.prefill_delay(r) for r in (0, 1)], inj.log


@pytest.mark.parametrize("seed", [0, 5, 17])
def test_injector_schedule_and_log_match_reference(seed):
    jp, jf, jpre, jd, jlog = _plan(JInjector, seed)
    tp, tf, tpre, td, tlog = _plan(TInjector, seed)
    # repr: the NaN values compare equal as text
    assert tp == jp and repr(tpre) == repr(jpre) and td == jd
    assert repr(tlog) == repr(jlog)
    for a, b in zip(tf, jf):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert sum(f is not None for f in tf) >= 3


def _cfgs(**kw):
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", **kw)
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("kw", [dict(), dict(seed=9, at=2.5, ttl=4.0, rid0=10,
                                             prompt_len=5, max_new_tokens=3)])
def test_burst_storm_matches_reference(kw):
    jcfg, tcfg = _cfgs()
    for a, b in zip(t_storm(tcfg, 4, **kw), j_storm(jcfg, 4, **kw)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.tokens.dtype == b.tokens.dtype
        assert (a.rid, a.max_new_tokens, a.arrival, a.ttl) == (
            b.rid, b.max_new_tokens, b.arrival, b.ttl)


@pytest.fixture(scope="module")
def packs():
    """The reference's ``build_pack_state`` over seeded block masks (two
    projections and a 3-D expert bank, block 16, with Top-KAST supersets)
    and the port's bridge of it."""
    from repro.core.pack import build_pack_state

    rng = np.random.default_rng(0)

    def blocks(shape, p):
        b = rng.random((*shape[:-2], shape[-2] // BLOCK, shape[-1] // BLOCK)) < p
        return np.repeat(np.repeat(b, BLOCK, -2), BLOCK, -1)

    masks = {"layers": [
        {"attn": {"wq": {"w": blocks((64, 128), 0.3)}},
         "mlp": {"wi": {"w": blocks((128, 64), 0.3)}}},
        {"moe": {"wi": blocks((4, 64, 32), 0.4)}}]}
    bwd = jax.tree_util.tree_map(lambda m: m | blocks(m.shape, 0.2), masks)
    jpack = build_pack_state(masks, (BLOCK, BLOCK), bwd_masks=bwd)
    like = jax.tree_util.tree_map(lambda m: torch.zeros(m.shape), masks)
    return jpack, bridge.pack_from_flat(_flat_pack(jpack), like, "cpu")


def _flat_pack(pack):
    flat, _ = jax.tree_util.tree_flatten_with_path(pack, is_leaf=is_pack_entry)
    return {path_name(p): e for p, e in flat if e is not None}


@pytest.mark.parametrize("mode", ["truncate", "oob", "nnz"])
@pytest.mark.parametrize("seed", [0, 3])
def test_truncate_pack_matches_reference_and_is_rejected(packs, mode, seed):
    jpack, tpack = packs
    assert validate_pack(tpack) > 0
    before = bridge.pack_flat_of(tpack)
    bad = t_truncate(tpack, mode=mode, seed=seed)
    want = _flat_pack(j_truncate(jpack, mode=mode, seed=seed))
    got = bridge.pack_flat_of(bad)
    for n, e in want.items():
        for k, v in e.items():
            assert np.array_equal(np.asarray(got[n][k]), np.asarray(v)), (n, k)
    with pytest.raises(PackIntegrityError):
        validate_pack(bad)
    # the caller's pack is untouched and still valid
    after = bridge.pack_flat_of(tpack)
    assert all(np.array_equal(np.asarray(after[n][k]), np.asarray(v))
               for n, e in before.items() for k, v in e.items())
    validate_pack(tpack)


def test_engine_rejects_a_corrupt_pack(packs):
    _, tpack = packs
    _, tcfg = _cfgs()
    with pytest.raises(PackIntegrityError, match="ServeEngine.pack"):
        TEngine(tcfg, {"embed": {"table": torch.zeros(4, 4)}}, capacity=1,
                max_len=16, pack=t_truncate(tpack, mode="nnz"))


# ---------------------------------------------------------------------------
# the engine's failure edges, against the reference engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp, _, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(jp).items()}, "cpu")
    return (jcfg, jp), (tcfg, tp)


def _drain(engine, dt=1.0):
    now = 0.0
    for _ in range(2000):
        if not (len(engine.queue) or engine.active.any()):
            return now
        engine.step(now)
        now += dt
    raise AssertionError("engine failed to drain")


def _serve(side, Engine, storm, n=6, faults=None, reqs_hook=None, **kw):
    cfg, params = side
    eng = Engine(cfg, params, capacity=3, max_len=32, faults=faults, **kw)
    reqs = storm(cfg, n, prompt_len=8, max_new_tokens=6)
    if reqs_hook is not None:
        reqs_hook(reqs)
    for r in reqs:
        assert eng.submit(r)
    _drain(eng)
    return eng


def _by_status(eng):
    out = {}
    for r in eng.queue.done:
        out.setdefault(r.status.value, []).append(r.rid)
    return {k: sorted(v) for k, v in out.items()}


def _streams(eng):
    return {r.rid: list(r.generated) for r in eng.queue.done
            if r.status.value == Status.DONE.value}


@pytest.fixture(scope="module")
def clean(weights):
    _, tside = weights
    return _streams(_serve(tside, TEngine, t_storm, n=9))


def test_quarantine_isolates_one_request(weights, clean):
    """(step 2, slot 0) poisons rid 0 mid-decode; the reference's engine
    logs the same quarantine; every other stream is the fault-free one."""
    jside, tside = weights
    je = _serve(jside, JEngine, j_storm, faults=JInjector().poison_logits(2, 0))
    te = _serve(tside, TEngine, t_storm, faults=TInjector().poison_logits(2, 0))
    assert te.quarantine_log == je.quarantine_log == [(2, 0, 0, 0, "decode")]
    assert _by_status(te) == _by_status(je) == {"failed": [0], "done": [1, 2, 3, 4, 5]}
    failed = next(r for r in te.queue.done if r.rid == 0)
    assert "non-finite" in failed.error and te.n_quarantined == 1
    assert _streams(te) == _streams(je) == {r: clean[r] for r in range(1, 6)}


def test_retry_recovers_exact_stream_with_backoff(clean, weights):
    _, tside = weights

    def slow(reqs):
        reqs[0].retry_backoff = 3.0  # dt = 1 a step: the retry must wait

    te = _serve(tside, TEngine, t_storm, faults=TInjector().poison_logits(2, 0),
                max_retries=2, reqs_hook=slow)
    assert _streams(te) == {r: clean[r] for r in range(6)}
    assert te.n_quarantined == 1 and te.n_retries_total == 1
    r0 = next(r for r in te.queue.done if r.rid == 0)
    assert r0.n_retries == 1 and r0.t_admitted >= r0.retry_at > 0


def test_retry_exhaustion_lands_failed(weights, clean):
    jside, tside = weights
    je = _serve(jside, JEngine, j_storm, n=4, faults=JInjector().poison_prefill(1),
                max_retries=2)
    te = _serve(tside, TEngine, t_storm, n=4, faults=TInjector().poison_prefill(1),
                max_retries=2)
    r1 = next(r for r in te.queue.done if r.rid == 1)
    assert r1.status is Status.FAILED and r1.n_retries == 2 and "prefill" in r1.error
    assert te.n_quarantined == 3 and te.quarantine_log == je.quarantine_log
    # (rid, attempt) of every fired prefill fault, as the reference logs them
    assert [e[:3] for e in te.faults.log] == [e[:3] for e in je.faults.log] == [
        ("prefill", 1, a) for a in range(3)]
    assert all(np.isnan(e[3]) for e in te.faults.log)
    assert _streams(te) == {r: clean[r] for r in (0, 2, 3)}


def test_deadline_shed_under_storm(weights):
    """9 requests, capacity 3, a ttl of 8 virtual seconds: the third wave
    sheds, never early, and the same requests as the reference's."""
    jside, tside = weights
    je = _serve(jside, JEngine, j_storm, n=9, deadline=8.0)
    te = _serve(tside, TEngine, t_storm, n=9, deadline=8.0)
    got = _by_status(te)
    assert got == _by_status(je) and got["shed"] and got["done"]
    for r in te.queue.done:
        if r.status is Status.SHED:
            assert "deadline" in r.error and r.t_done > r.expires_at - 1e-9
        else:
            assert r.t_admitted - r.arrival <= 8.0
    s = te.stats(1.0)
    assert s["shed"] == len(got["shed"]) and s["requests"] == len(got["done"])


def test_quarantine_log_matches_reference_under_a_random_storm(weights, clean):
    """Seeded random decode poisonings (one retry each) and a poisoned
    prefill: the same quarantine log, statuses and streams as the
    reference's, and the finished streams the fault-free ones."""
    jside, tside = weights
    plan = lambda Inj: Inj(seed=3).poison_prefill(4)
    jinj, tinj = plan(JInjector), plan(TInjector)
    assert jinj.poison_random(4, max_step=12, capacity=3) == tinj.poison_random(
        4, max_step=12, capacity=3)
    je = _serve(jside, JEngine, j_storm, n=7, faults=jinj, max_retries=1)
    te = _serve(tside, TEngine, t_storm, n=7, faults=tinj, max_retries=1)
    assert te.quarantine_log == je.quarantine_log and len(te.quarantine_log) >= 3
    assert _by_status(te) == _by_status(je)
    assert [e[:3] for e in te.faults.log] == [e[:3] for e in je.faults.log]
    assert _streams(te) == _streams(je) == {r: clean[r] for r in _streams(te)}


def test_prefill_delay_under_the_wall_clock(weights):
    """``delay_prefill`` sleeps the host before that request's prefill in
    ``run()`` (wall clock), and the request still completes."""
    _, (cfg, params) = weights
    eng = TEngine(cfg, params, capacity=2, max_len=32,
                  faults=TInjector().delay_prefill(0, 0.2))
    for r in t_storm(cfg, 2, prompt_len=8, max_new_tokens=2):
        eng.submit(r)
    t0 = time.monotonic()
    stats = eng.run()
    assert time.monotonic() - t0 >= 0.2 and stats["requests"] == 2


def test_paged_pools_leak_free_under_quarantine_storm():
    """Every way out of a slot — DONE, a decode quarantine with its retry,
    prefill quarantines through retry exhaustion to FAILED — returns its
    pages: after the storm live pages are exactly the prefix cache's holds
    and the books balance (``check_pool_accounting``)."""
    from repro_torch.models.model import init_lm

    cfg = dataclasses.replace(t_get_config("mistral-large-123b", smoke=True),
                              dtype="float32")
    params, _ = init_lm(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    faults = TInjector(seed=3)
    faults.poison_random(6, max_step=25, capacity=3)
    faults.poison_prefill(4).poison_prefill(7)
    eng = TEngine(cfg, params, capacity=3, max_len=32, faults=faults, paged=True,
                  page_size=8, prefix_cache=2, max_retries=1)
    for i in range(10):
        suffix = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(1, 8))).astype(np.int32)
        eng.submit(Request(rid=i, tokens=np.concatenate([prefix, suffix]),
                           max_new_tokens=6, share_prefix_len=16, max_retries=1,
                           retry_backoff=0.5, ttl=200.0))
    _drain(eng)
    assert eng.n_quarantined > 0 and eng.n_retries_total > 0
    assert _by_status(eng)["failed"] == [4, 7] and len(_by_status(eng)["done"]) == 8
    eng.check_pool_accounting()
    cache_pages = {p for e in eng._prefix_entries.values() for p in e.pages}
    assert eng.pools["global"].n_live == len(cache_pages)
    assert all(not sp for sp in eng.slot_pages)
    while eng._prefix_entries:
        eng._evict_prefix()
    eng.check_pool_accounting()
    assert eng.pools["global"].n_live == 0


def test_faults_none_takes_the_plain_path(weights, monkeypatch):
    """Without an injector the engine never consults one: a decode step
    uploads no fault rows and the streams are the plain ones."""
    _, tside = weights
    calls = []
    monkeypatch.setattr(TInjector, "decode_fault",
                        lambda self, *a: calls.append(a))
    eng = _serve(tside, TEngine, t_storm, n=3)
    assert calls == [] and eng.faults is None and eng.quarantine_log == []
