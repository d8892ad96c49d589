"""K12's split key walk on the CPU: the plan (``paged_split_plan``), the
plain merge of split partials (``merge_partials_plain``) against the unsplit
plain version, and the merged result against the JAX reference kernel.

A split's partial is the plain version on its sub-table with
ctx' = clamp(ctx - k0, 0, k1 - k0): its normalised o stands for the
unnormalised sum with l = 1 and m = lse (l = 0, m = -1e30 where the split
holds no live key), which the merge weighs as it weighs the kernel's
(o, m, l).  Tolerances: f32 1e-5 of the largest magnitude against the
unsplit plain version (the same softmax summed in another order); against
the reference, as ``tests/test_torch_paged.py`` holds K12's plain version:
f32 1e-5, bf16 1e-2 (one bf16 rounding of o on each side and the
reference's bf16 p).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_paged as j_paged  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

pytestmark = pytest.mark.paged

N_SM = 132  # an H100's SMs; the plan takes it as a number

PLANS = {
    # name: (B, KV, R, T, bs, n_split expected)
    "serve path: one 16-row suffix, 96 over 8 heads, 37 pages": (1, 8, 192, 37, 16, 5),
    "k12 cases, Sq 16": (4, 8, 192, 256, 16, 2),
    "k12 cases, Sq 128: grid already large": (4, 8, 1536, 256, 16, 1),
    "T*bs below one tile": (1, 8, 192, 5, 16, 1),
    "G = 1, 16 KV heads, 2 rows": (1, 16, 2, 40, 16, 5),
}


def _grid(B, KV, R, n_split):
    return B * KV * -(-R // tfa.PAGED_ROWS) * n_split


@pytest.mark.parametrize("name", sorted(PLANS))
def test_paged_split_plan_covers_every_tile(name):
    B, KV, R, T, bs, want = PLANS[name]
    n_split, ranges = tfa.paged_split_plan(B, KV, R, T, bs, N_SM)
    assert n_split == want == len(ranges)
    # every key of T * bs in exactly one split, in order, on tile bounds
    assert ranges[0][0] == 0 and ranges[-1][1] == T * bs
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % tfa.SPLIT_KEYS == 0
        assert k1 % tfa.SPLIT_KEYS == 0 or k1 == T * bs
    tiles = -(-T * bs // tfa.SPLIT_KEYS)
    # the smallest split that reaches n_sm CTAs, where the tiles allow
    assert _grid(B, KV, R, n_split) >= N_SM or n_split == tiles
    if n_split > 1:
        assert _grid(B, KV, R, n_split - 1) < N_SM


def _inputs(seed, *, B, H, KV, Sq, d, bs, T, ctx):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, d)).astype(np.float32)
    n_pages = sum(-(-c // bs) for c in ctx)
    N = n_pages + 3
    pk, pv = (rng.standard_normal((N, bs, KV, d)).astype(np.float32) for _ in range(2))
    table = np.full((B, T), N, np.int32)  # sentinel tails
    perm = rng.permutation(N)
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        table[b, :n], perm = perm[:n], perm[n:]
    return q, pk, pv, table, np.asarray(ctx, np.int32)


def _split_merge(q, pk, pv, table, ctx, ranges, softcap):
    """Each split's partial by the plain version on its sub-table, merged."""
    bs = pk.shape[1]
    o_p, m_p, l_p = [], [], []
    for k0, k1 in ranges:
        sub = table[:, k0 // bs: -(-k1 // bs)].contiguous()
        c = (ctx.long() - k0).clamp(0, k1 - k0).to(torch.int32)
        o, lse = tfa.flash_attention_paged_plain(q, pk, pv, sub, c, softcap=softcap)
        live = lse > -1e29
        o_p.append(o.float())
        m_p.append(lse)
        l_p.append(live.float())
    return tfa.merge_partials_plain(torch.stack(o_p), torch.stack(m_p), torch.stack(l_p))


CASES = {
    # name: (G, softcap, Sq)
    "G=1": (1, 0.0, 5),
    "G=3": (3, 0.0, 5),
    "G=3 softcap": (3, 5.0, 5),
    "G=4 Sq=16": (4, 0.0, 16),
}
CTX = [0, 6, 150, 288]  # none, inside a page, across a split bound, all keys


def _case(name):
    G, softcap, Sq = CASES[name]
    KV, bs, T = 2, 16, 18  # 288 keys: 3 tiles of 128
    arrs = _inputs(G + Sq, B=len(CTX), H=KV * G, KV=KV, Sq=Sq, d=16, bs=bs, T=T, ctx=CTX)
    n_split, ranges = tfa.paged_split_plan(len(CTX), KV, G * Sq, T, bs, N_SM)
    assert n_split == 3
    return arrs, ranges, softcap


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_split_merge_equals_unsplit(name):
    (q, pk, pv, table, ctx), ranges, softcap = _case(name)
    q, pk, pv, table, ctx = (torch.from_numpy(a) for a in (q, pk, pv, table, ctx))
    o, lse = _split_merge(q, pk, pv, table, ctx, ranges, softcap)
    want_o, want_l = tfa.flash_attention_paged_plain(q, pk, pv, table, ctx, softcap=softcap)
    tol = 1e-5 * max(1.0, want_o.abs().max().item())
    assert (o - want_o).abs().max().item() <= tol
    live = want_l > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], want_l[live], rtol=1e-5, atol=1e-5)
    # ctx = 0: exactly the empty row's lse and o = 0
    assert bool((lse[0] == -1e30).all()) and bool((o[0] == 0).all())
    assert int((~live).sum()) == q.shape[1] * q.shape[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["G=3", "G=3 softcap"])
def test_paged_split_merge_matches_reference_kernel(name, dtype):
    (q, pk, pv, table, ctx), ranges, softcap = _case(name)
    jo, jl = j_paged(*(jnp.asarray(a, dtype) for a in (q, pk, pv)), jnp.asarray(table),
                     jnp.asarray(ctx), bq=16, softcap=softcap)
    tt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tt) for a in (q, pk, pv))
    o, lse = _split_merge(tq, tk, tv, torch.from_numpy(table), torch.from_numpy(ctx),
                          ranges, softcap)
    o = o.to(tt).float().numpy()
    jo = np.asarray(jo, np.float32)
    tol = (1e-5 if dtype == "float32" else 1e-2) * max(1.0, float(np.abs(jo).max()))
    assert float(np.abs(o - jo).max()) <= tol
    jl = np.asarray(jl)
    live = jl > -1e29
    assert (lse.numpy()[~live] == np.float32(-1e30)).all()
    assert (~live).sum() == q.shape[1] * q.shape[2]  # exactly the ctx = 0 row
    np.testing.assert_allclose(lse.numpy()[live], jl[live], rtol=1e-5, atol=1e-5)
    assert (o[0] == 0).all()


def test_merge_partials_plain_weighs_by_max():
    """Two partials of one row by hand: the merge is the softmax over the
    union, and an empty partial (l = 0, m = -1e30) weighs nothing."""
    s = torch.tensor([0.5, -1.0, 2.0, 0.25])
    v = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.0, 4.0], [-2.0, 1.0]])
    parts = []
    for sl in (slice(0, 2), slice(2, 4)):
        m = s[sl].max()
        p = torch.exp(s[sl] - m)
        parts.append((p @ v[sl], m, p.sum()))
    parts.append((torch.zeros(2), torch.tensor(-1e30), torch.tensor(0.0)))
    o, lse = tfa.merge_partials_plain(*(torch.stack(x) for x in zip(*parts)))
    torch.testing.assert_close(o, torch.softmax(s, 0) @ v, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, 0), rtol=1e-6, atol=1e-6)
    o0, lse0 = tfa.merge_partials_plain(torch.zeros(3, 2), torch.full((3,), -1e30),
                                        torch.zeros(3))
    assert bool((o0 == 0).all()) and lse0.item() == np.float32(-1e30)
