"""K10/K11's balanced walks on the CPU: the plan (``bwd_plan``), the walks it
gives (``bwd_walks``: 64-row units and sub-tiles, dead sub-tiles dropped,
units paired, walks split), and the plain version that follows them
(``flash_bwd_walked_plain``) against the unbalanced plain version and
against the JAX reference's VJP (its Pallas kernels in interpret mode).

Tolerances: against ``flash_bwd_plain``, ``grad_error_bound`` per element
(the same products summed in another order, p and ds rounded to bf16 from
f32 values that may differ in the last bits); against the reference, as
tests/test_torch_grads.py holds the FlashAttention Function: f32 1e-5,
bf16 2**-6 of the largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.core.attn_sched import sched_for  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

N_SM = 132  # an H100's SMs; the plan takes it as a number

WALKS = {
    # name: (Sq, Sk, causal, window, G, (bq, bk) or None)
    "causal S=300 (ragged, bq 128)": (300, 300, True, 0, 4, None),
    "window 100 S=400 (edges inside tiles)": (400, 400, True, 100, 2, None),
    "window 4096 >= S=1024 (purely causal)": (1024, 1024, True, 4096, 4, None),
    "bq = bk = 112 (a 48-row unit)": (100, 100, True, 0, 1, None),
    "q_offset 223 (Sq 77, Sk 300)": (77, 300, True, 0, 2, None),
    "dead rows (Sq 90 > Sk 40)": (90, 40, True, 0, 2, None),
    "blocks 64, 5 units (odd)": (320, 320, True, 0, 4, (64, 64)),
    "no mask": (200, 200, False, 0, 2, None),
}
PLANS = [(False, 1), (True, 1), (False, 2), (True, 3), (True, 4)]


def _setup(name):
    Sq, Sk, causal, window, G, blocks = WALKS[name]
    bq, bk = blocks or tfa.effective_blocks(Sq, Sk)
    sched = sched_for(Sq, Sk, bq, bk, causal, window, Sk - Sq)
    Sqp, Skp = -(-Sq // bq) * bq, -(-Sk // bk) * bk
    return Sq, Sk, causal, window, G, bq, bk, Sqp, Skp, sched


def _walks(kind, sched, bq, bk, causal, window, Sq, Sk, G, pair, n_split, rows=64):
    idx, cnt = ((sched["kv_idx"], sched["kv_cnt"]) if kind == "dq"
                else (sched["q_idx"], sched["q_cnt"]))
    return tfa.bwd_walks(kind, idx, cnt, bq=bq, bk=bk, causal=causal, window=window,
                         q_offset=Sk - Sq, sk=Sk, groups=G, unit_rows=rows, pair=pair,
                         n_split=n_split)


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"pair={p[0]}-split={p[1]}")
@pytest.mark.parametrize("name", sorted(WALKS))
def test_bwd_walks_cover_every_live_pair_once(name, plan):
    """Per grid row, every visible (q, k) pair (K10, with 64- and 128-row
    units) and every visible (member, q, k) triple (K11) lies in exactly
    one walked tile; no walked tile is wholly dead (dead sub-tiles are
    dropped); each unit is walked by exactly one CTA per split, each split
    in its place; a pair's second unit is the first's mirror
    n_units - 1 - j."""
    Sq, Sk, causal, window, G, bq, bk, Sqp, Skp, sched = _setup(name)
    pair, n_split = plan
    blocks = tfa._schedule_mask(sched["kv_idx"], sched["kv_cnt"], Skp // bk, "cpu")
    vis = tfa._visible(Sqp, Skp, blocks, bq=bq, bk=bk, causal=causal, window=window,
                       q_offset=Sk - Sq, sk=Sk, device="cpu")
    for kind, size in (("dq", 64), ("dq", 128), ("dkv", 64)):
        walks = _walks(kind, sched, bq, bk, causal, window, Sq, Sk, G, pair, n_split, size)
        seen = torch.zeros(G, Sqp, Skp, dtype=torch.int32)
        n_rows = Sqp if kind == "dq" else Skp
        units = torch.zeros(n_split, n_rows, dtype=torch.int32)
        blk = bq if kind == "dq" else bk
        parts = -(-blk // size)
        n_units = parts * (n_rows // blk)
        unit_of = lambda row0: (row0 // blk) * parts + (row0 % blk) // size
        assert len(walks) == (-(-n_units // 2) if pair else n_units) * n_split
        for x, (s, mine) in enumerate(walks):
            assert s == x % n_split and len(mine) <= 2
            for row0, rows, steps in mine:
                units[s, row0:row0 + rows] += 1
                for gm, t0, n in steps:
                    q_r, k_r = ((slice(row0, row0 + rows), slice(t0, t0 + n)) if kind == "dq"
                                else (slice(t0, t0 + n), slice(row0, row0 + rows)))
                    assert bool(vis[q_r, k_r].any()), "a dead sub-tile was walked"
                    seen[gm if kind == "dkv" else slice(None), q_r, k_r] += 1
            if len(mine) == 2:
                assert unit_of(mine[1][0]) == n_units - 1 - unit_of(mine[0][0])
        assert bool((units == 1).all())
        cover = seen[:1] if kind == "dq" else seen
        assert bool((cover[:, vis] == 1).all()) and bool((cover[:, ~vis] <= 1).all())


# (kind, BH, G, d, S, window, plan) at chip_smoke's K10/K11 cases: the
# plan the model gives (chip_smoke.py times every candidate on the card;
# PERF.md)
CHIP_PLANS = {
    "K10 danube S=1024 window 4096": ("dq", 64, 4, 80, 1024, 4096, (True, 1)),
    "K11 danube S=1024 window 4096": ("dkv", 64, 4, 80, 1024, 4096, (True, 3)),
    "K10 danube S=512 window 256": ("dq", 32, 4, 80, 512, 256, (False, 2)),
    "K11 danube S=512 window 256": ("dkv", 32, 4, 80, 512, 256, (False, 4)),
    "K10 danube S=300 causal": ("dq", 32, 4, 80, 300, 0, (False, 2)),
    "K11 danube S=300 causal": ("dkv", 32, 4, 80, 300, 0, (False, 4)),
    "K10 danube S=512 causal": ("dq", 32, 4, 80, 512, 0, (False, 2)),
    "K11 danube S=512 causal": ("dkv", 32, 4, 80, 512, 0, (False, 4)),
    "K10 qwen2-moe S=1024 causal": ("dq", 16, 1, 128, 1024, 0, (True, 2)),
    "K11 qwen2-moe S=1024 causal": ("dkv", 16, 1, 128, 1024, 0, (True, 2)),
}


@pytest.mark.parametrize("name", sorted(CHIP_PLANS))
def test_bwd_plan_picks_the_shortest_schedule(name):
    """``bwd_plan`` at the yardstick shapes: the plan of the shortest
    modelled makespan (checked against every candidate here); and the
    wrapper's memoized plan agrees."""
    kind, BH, G, d, S, window, want = CHIP_PLANS[name]
    bq, bk = tfa.effective_blocks(S, S)
    sched = sched_for(S, S, bq, bk, True, window, 0)
    n_rows = BH if kind == "dq" else BH // G
    slots = N_SM * tfa.bwd_ctas_per_sm(kind, d)
    args = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S, groups=G,
                unit_rows=tfa.bwd_unit_rows(kind, d))
    idx, cnt = ((sched["kv_idx"], sched["kv_cnt"]) if kind == "dq"
                else (sched["q_idx"], sched["q_cnt"]))
    got = tfa.bwd_plan(kind, idx, cnt, n_rows=n_rows, slots=slots, **args)
    assert got == want

    def span(pair, n_split):  # the slots' list schedule, in launch order
        walks = tfa.bwd_walks(kind, idx, cnt, pair=pair, n_split=n_split, **args)
        free = np.zeros(slots)
        for _ in range(n_rows):
            for _, units in walks:
                i = int(np.argmin(free))
                free[i] += sum(1 + len(st) for _, _, st in units)
        return free.max()

    best = min(span(p, s) for p in (False, True) for s in range(1, tfa.BWD_MAX_SPLIT + 1))
    assert span(*got) == best
    Sp = -(-S // bq) * bq
    kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S, scale=d ** -0.5,
              softcap=0.0, kv_groups=G)
    assert tfa._bwd_plan_for(kind, Sp, Sp, d, n_rows, N_SM, **kw) == want


def test_bwd_plan_falls_back_on_foreign_shapes():
    """Shapes that are not a ``flash_attention`` schedule's (q_offset past
    sk) get the plain plan: one unit a CTA, no split."""
    kw = dict(bq=128, bk=128, causal=True, window=0, q_offset=2048, sk=1024, scale=0.1,
              softcap=0.0, kv_groups=1)
    assert tfa._bwd_plan_for("dq", 1024, 1024, 80, 8, N_SM, **kw) == (False, 1)


def _inputs(rng, Sq, Sk, G, d, dtype):
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    q, do = (to(rng.standard_normal((4, Sq, d))) for _ in range(2))
    k, v = (to(rng.standard_normal((4 // G, Sk, d))) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("plan", [(True, 3), (False, 2)], ids=["paired-split3", "split2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["causal S=300 (ragged, bq 128)",
                                  "window 100 S=400 (edges inside tiles)",
                                  "q_offset 223 (Sq 77, Sk 300)"])
def test_flash_bwd_walked_plain_matches_jax(name, dtype, plan):
    """The plain version that follows the kernels' plan (units paired and
    split, partials merged in order) against the reference's VJP (its
    K10/K11 in interpret mode) on the same inputs, and within
    ``grad_error_bound`` of the unbalanced plain version."""
    Sq, Sk, causal, window, G, bq, bk, Sqp, Skp, sched = _setup(name)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    d = 32
    q, k, v, do = _inputs(np.random.default_rng(len(name)), Sq, Sk, G, d, tdt)
    jkw = dict(causal=causal, window=window, bq=bq, bk=bk, softcap=0.0, kv_groups=G)
    j = lambda t: jnp.asarray(t.float().numpy(), jdt)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, interpret=True, **jkw),
                     j(q), j(k), j(v))
    want_j = vjp(j(do))

    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))
    qp, dop, kp, vp = pad(q, Sqp), pad(do, Sqp), pad(k, Skp), pad(v, Skp)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=Sk - Sq, sk=Sk,
              scale=d ** -0.5, softcap=0.0, kv_groups=G)
    idx = [torch.from_numpy(sched[n]) for n in ("kv_idx", "kv_cnt")]
    o, lse = tfa.flash_attention_plain(qp, kp, vp, *idx, **kw)
    delta = (dop.float() * o.float()).sum(-1)
    pair, n_split = plan
    walks = [_walks(kind, sched, bq, bk, causal, window, Sq, Sk, G, pair, n_split, rows)
             for kind, rows in (("dq", 128), ("dkv", 64))]
    got = tfa.flash_bwd_walked_plain(qp, kp, vp, dop, lse, delta, *walks, n_split_dq=n_split,
                                     n_split_dkv=n_split, **kw)
    blocks = tfa._schedule_mask(*idx, Skp // bk, "cpu")
    *want, rq, rk, rv, eq, ek, ev = tfa.flash_bwd_plain(qp, kp, vp, dop, lse, delta, blocks,
                                                        with_abs=True, **kw)
    tol = {"float32": 1e-5, "bfloat16": 2.0 ** -6}[dtype]
    for what, g, w, r, e, wj, n in zip(("dq", "dk", "dv"), got, want, (rq, rk, rv),
                                       (eq, ek, ev), want_j, (Sq, Sk, Sk)):
        if dtype == "bfloat16":
            assert bool(((g.float() - w.float()).abs() <= tfa.grad_error_bound(w, r, e)).all())
        ref = np.asarray(jnp.asarray(wj, jnp.float32))
        err = float(np.max(np.abs(g[:, :n].float().numpy() - ref)))
        assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), (what, err)
