"""Port autograd Functions vs the JAX package's custom VJPs: dx and dw of
the block-sparse matmul (plain and Top-KAST superset), and dq, dk and dv of
flash attention.

On the CPU the port's backward wrappers run their plain PyTorch versions
(the CUDA kernels K2, K3, K10 and K11 build and run only on the card); the
JAX side runs its Pallas kernels in interpret mode through ``jax.vjp``.
Inputs and cotangents are made from a seed with numpy and handed to both.
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.pack import pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear  # noqa: E402

BLOCK = 16
# Relative to the largest magnitude compared.  f32: the same products
# summed in another order.  bf16 block-sparse: both sides accumulate in f32
# and round once, so an output lands at most one bf16 ulp apart (2**-7).
# bf16 flash: p and ds are also rounded to bf16 on both sides before the
# products, from f32 values that differ in the last bits, so a rounding may
# land one ulp apart as well: two ulps (2**-6) at the largest magnitude.
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _close(got_t, want_j, tol, what):
    got = got_t.float().numpy()
    want = np.asarray(jnp.asarray(want_j, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _topology(rng, nkb, nnb):
    """A random block mask with an all-empty column AND an all-empty row
    (their dw blocks and dx tiles must come out as zeros), and a superset
    of it (the Top-KAST B ⊇ A) that revives the empty row."""
    bm = rng.random((nkb, nnb)) < 0.45
    bm[:, 1] = False
    bm[2, :] = False
    bm[0, 0] = True
    sup = bm | (rng.random((nkb, nnb)) < 0.3)
    sup[2, 3] = True
    return bm, sup


def _pack(bm):
    idx, cnt = pack_np(bm)
    ridx, rcnt = pack_np(bm.T)
    return idx, cnt, ridx, rcnt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topkast", [False, True])
def test_block_sparse_vjp_matches_jax(dtype, topkast):
    rng = np.random.default_rng(3)
    K, N, M = 64, 96, 32
    bm, sup = _topology(rng, K // BLOCK, N // BLOCK)
    dense = np.repeat(np.repeat(bm, BLOCK, 0), BLOCK, 1)
    w = rng.standard_normal((K, N)).astype(np.float32) * dense / np.sqrt(K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    (xt, xj), (wt, wj), (gt, gj) = (_as(a, dtype) for a in (x, w, g))
    idx, cnt, ridx, rcnt = _pack(bm)
    bidx, bcnt = pack_np(sup)
    blk = dict(bm=16, bn=BLOCK, bk=BLOCK)

    if topkast:
        jf = lambda a, b: jbsm.topkast_block_sparse_matmul(
            a, b, idx, cnt, bidx, bcnt, ridx, rcnt, interpret=True, **blk)
    else:
        jf = lambda a, b: jbsm.block_sparse_matmul(
            a, b, idx, cnt, ridx, rcnt, interpret=True, **blk)
    jy, vjp = jax.vjp(jf, xj, wj)
    jdx, jdw = vjp(gj)

    xt.requires_grad_(True)
    wt.requires_grad_(True)
    T = lambda a: torch.from_numpy(a)
    packs = [T(idx), T(cnt), T(ridx), T(rcnt)]
    if topkast:
        y = tbsm.TopkastBlockSparseMatmul.apply(xt, wt, *packs, T(bidx), T(bcnt),
                                                16, BLOCK, BLOCK)
    else:
        y = tbsm.BlockSparseMatmul.apply(xt, wt, *packs, 16, BLOCK, BLOCK)
    y.backward(gt)
    _close(y.detach(), jy, TOL[dtype], "y")
    _close(xt.grad, jdx, TOL[dtype], "dx")
    _close(wt.grad, jdw, TOL[dtype], "dw")
    # dw lives on the (superset) blocks only; the empty row's dx is zero
    support = np.repeat(np.repeat(sup if topkast else bm, BLOCK, 0), BLOCK, 1)
    assert not wt.grad.float().numpy()[~support].any()
    assert not xt.grad.float().numpy()[:, 2 * BLOCK:3 * BLOCK].any()


@pytest.mark.parametrize("pack_kind", ["entry", "csc_tuple"])
@pytest.mark.parametrize("M", [5, 40])
def test_block_sparse_linear_grads_match_jax(M, pack_kind):
    """The dispatch wrapper: leading dims flattened, rows padded to the row
    tile and trimmed; a pack entry with its CSR and superset views, or a
    bare CSC tuple (dx on a CSR derived at the worst-case width, dw on the
    CSC)."""
    rng = np.random.default_rng(4)
    K, N = 48, 64
    bm, sup = _topology(rng, K // BLOCK, N // BLOCK)
    dense = np.repeat(np.repeat(bm, BLOCK, 0), BLOCK, 1)
    w = rng.standard_normal((K, N)).astype(np.float32) * dense
    x = rng.standard_normal((2, M, K)).astype(np.float32)
    g = rng.standard_normal((2, M, N)).astype(np.float32)
    idx, cnt, ridx, rcnt = _pack(bm)
    bidx, bcnt = pack_np(sup)
    jpack = {"idx": idx, "cnt": cnt, "ridx": ridx, "rcnt": rcnt,
             "bidx": bidx, "bcnt": bcnt}
    tpack = {k: torch.from_numpy(v) for k, v in jpack.items()}
    if pack_kind == "csc_tuple":
        jpack, tpack = (idx, cnt), (tpack["idx"], tpack["cnt"])
    block = (128, BLOCK, BLOCK)
    jy, vjp = jax.vjp(lambda a, b: jops.block_sparse_linear(
        a, b, pack=jpack, block=block, interpret=True), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = block_sparse_linear(xt, wt, pack=tpack, block=block)
    y.backward(torch.from_numpy(g))
    _close(y.detach(), jy, TOL["float32"], "y")
    _close(xt.grad, jdx, TOL["float32"], "dx")
    _close(wt.grad, jdw, TOL["float32"], "dw")


FLASH_CASES = {
    # name: (Sq, Sk, causal, window, softcap, kv_groups)
    "causal": (64, 64, True, 0, 0.0, 1),
    "window": (96, 96, True, 40, 0.0, 2),
    "gqa": (64, 64, True, 0, 0.0, 4),
    "softcap": (64, 64, True, 0, 30.0, 2),
    "ragged": (50, 50, True, 0, 0.0, 2),
    "q_offset": (32, 80, True, 0, 0.0, 2),
    "dead_rows": (40, 24, True, 0, 0.0, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_vjp_matches_jax(case, dtype):
    """dq, dk, dv of the FlashAttention Function against the reference's
    custom VJP (K10/K11 in interpret mode), 16x16 blocks so the schedules
    have several live blocks per row; ragged shapes pad and trim."""
    Sq, Sk, causal, window, softcap, G = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    BH, d = 4, 32
    q = rng.standard_normal((BH, Sq, d)).astype(np.float32)
    k = rng.standard_normal((BH // G, Sk, d)).astype(np.float32)
    v = rng.standard_normal((BH // G, Sk, d)).astype(np.float32)
    do = rng.standard_normal((BH, Sq, d)).astype(np.float32)
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (_as(a, dtype) for a in (q, k, v, do))
    kw = dict(causal=causal, window=window, bq=16, bk=16, softcap=softcap,
              kv_groups=G)
    jo, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, interpret=True, **kw), qj, kj, vj)
    jdq, jdk, jdv = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    o = tfa.flash_attention(qt, kt, vt, **kw)
    o.backward(dot)
    tol = FLASH_TOL[dtype]
    _close(o.detach(), jo, tol, "o")
    _close(qt.grad, jdq, tol, "dq")
    _close(kt.grad, jdk, tol, "dk")
    _close(vt.grad, jdv, tol, "dv")


def test_flash_backward_dead_rows_give_zero_not_nan():
    """Sq > Sk right-aligned: query rows 0..15 sit at negative positions and
    see no key under the causal mask.  The forward gives them o = 0 and
    lse = +1e30; the backward must give them dq = 0 (not NaN) and let them
    add nothing to dk and dv."""
    rng = np.random.default_rng(12)
    q, do = (torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32))
            for _ in range(2))
    for t in (q, k, v):
        t.requires_grad_(True)
    o = tfa.flash_attention(q, k, v, causal=True, bq=16, bk=16)
    o.backward(do)
    assert not o[:, :16].detach().any()
    assert not q.grad[:, :16].any()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    q.grad = k.grad = v.grad = None
    tfa.flash_attention(q[:, 16:], k, v, causal=True, bq=16, bk=16).backward(do[:, 16:])
    live_dk, live_dv = k.grad.clone(), v.grad.clone()
    q.grad = k.grad = v.grad = None
    tfa.flash_attention(q, k, v, causal=True, bq=16, bk=16).backward(do)
    torch.testing.assert_close(k.grad, live_dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v.grad, live_dv, rtol=1e-5, atol=1e-6)


def _flash_bwd_tiles(q, k, v, do, lse, delta, sched, *, b, window, G, softcap,
                     fault=None):
    """The backward kernels' arithmetic tile by tile on the CPU, walking the
    schedule: per live (q-block, KV-block) tile f32 scores and do @ v^T, p
    and ds rounded to bf16, f32 accumulators.  ``fault`` plants one of the
    errors the gradient check must see: ds without the softcap's chain
    factor, ds without delta, the wrong GQA row, the wrong K/V block on one
    step, or dk/dv summed over one group member only."""
    BH, S, d = q.shape
    scale = d ** -0.5
    kv = torch.arange(BH) // G
    krow = (kv + 1) % (BH // G) if fault == "gqa_row" else kv
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(v.shape)
    for qb in range(S // b):
        rows = slice(qb * b, (qb + 1) * b)
        qpos = torch.arange(qb * b, (qb + 1) * b)[:, None]
        for step in range(int(sched["kv_cnt"][qb])):
            kb = int(sched["kv_idx"][qb, step])
            if fault == "kv_block" and step == 0:
                kb = (kb + 1) % (S // b)
            cols = slice(kb * b, (kb + 1) * b)
            kpos = torch.arange(kb * b, (kb + 1) * b)[None, :]
            u = q[:, rows].float() @ k[krow, cols].float().transpose(1, 2) * scale
            t = torch.tanh(u / softcap)
            ok = (kpos <= qpos) & (kpos > qpos - window)
            p = torch.where(ok, torch.exp(softcap * t - lse[:, rows, None]), 0.0)
            dp = do[:, rows].float() @ v[krow, cols].float().transpose(1, 2)
            ds = p * (dp - (0.0 if fault == "no_delta" else delta[:, rows, None])) * scale
            if fault != "no_chain":
                ds = ds * (1.0 - t * t)
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
            dq[:, rows] += ds @ k[krow, cols].float()
            keep = (torch.arange(BH) % G == 0) if fault == "one_member" else torch.ones(BH, dtype=torch.bool)
            dk[:, cols].index_add_(0, kv[keep], (ds.transpose(1, 2) @ q[:, rows].float())[keep])
            dv[:, cols].index_add_(0, kv[keep], (p.transpose(1, 2) @ do[:, rows].float())[keep])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _flash_bwd_planned(q, k, v, do, lse, delta, sched, kw, *, pair, n_split, dq_rows,
                       fault=None):
    """The backward kernels' new walk on the CPU: K10 units of ``dq_rows``
    query rows, K11 units of 64 KV rows, 64-row sub-tiles, dead sub-tiles
    dropped, units paired and walks split as (pair, n_split) say
    (``tfa.bwd_walks``), through the plain version that follows it
    (``tfa.flash_bwd_walked_plain``).  ``fault`` plants a walk error: one
    live sub-tile skipped in one unit of K10 and of K11, or one sub-tile
    replaced by its neighbour."""
    wk = dict(bq=kw["bq"], bk=kw["bk"], causal=kw["causal"], window=kw["window"],
              q_offset=kw["q_offset"], sk=kw["sk"], groups=kw["kv_groups"], pair=pair,
              n_split=n_split)
    walks = [tfa.bwd_walks("dq", sched["kv_idx"], sched["kv_cnt"], unit_rows=dq_rows, **wk),
             tfa.bwd_walks("dkv", sched["q_idx"], sched["q_cnt"], unit_rows=tfa.BWD_ROWS,
                           **wk)]
    if fault is not None:
        for w in walks:
            steps = next(st for _, units in w for _, _, st in units if st)
            gm, t0, n = steps[0]
            if fault == "skip_sub_tile":
                del steps[0]
            else:  # "wrong_sub_tile"
                steps[0] = (gm, t0 + tfa.BWD_ROWS, n)
    return tfa.flash_bwd_walked_plain(q, k, v, do, lse, delta, *walks, n_split_dq=n_split,
                                      n_split_dkv=n_split, **kw)


BOUND_FAULTS = [pytest.param("blocks", None, id="None")] + [
    pytest.param("blocks", f, id=f) for f in ("no_chain", "no_delta", "gqa_row", "kv_block",
                                               "one_member")] + [
    pytest.param(plan, f, id=f"{plan}-{f}")
    for plan in ("paired", "split3", "paired_split2")
    for f in (None, "skip_sub_tile", "wrong_sub_tile")]
# (pair, n_split, K10 unit rows): 128-row K10 units are d = 80's
PLANS = {"paired": (True, 1, 128), "split3": (False, 3, 64), "paired_split2": (True, 2, 128)}


@pytest.mark.parametrize("walk,fault", BOUND_FAULTS)
def test_flash_grad_bound_holds_and_catches_faults(walk, fault):
    """``grad_error_bound`` (the per-element dq/dk/dv check of the CUDA
    kernels K10/K11 against the plain version) holds for the kernels' own
    tile-by-tile arithmetic and fails for each planted fault: on the
    schedule's 32-row blocks, and on the kernels' walk (128-row blocks cut
    into 64-row sub-tiles, dead sub-tiles skipped, 64- or 128-row units
    paired and walks split as the balanced CTA order does, f32 partials
    merged in order) with a live sub-tile skipped or replaced."""
    from repro_torch.core.attn_sched import sched_for

    S, window, G, d, b, softcap = 128, 80, 2, 32, 32, 2.0
    if walk != "blocks":  # a window edge inside 64-key tiles, S not a multiple of 128
        S, window, b = 320, 150, 128
    rng = np.random.default_rng(13)
    Sp = -(-S // b) * b
    q, k, v = (torch.from_numpy(rng.standard_normal((n, Sp, d)).astype(np.float32))
               .to(torch.bfloat16) for n in (4, 4 // G, 4 // G))
    do = torch.from_numpy(rng.standard_normal((4, Sp, d)).astype(np.float32)).to(torch.bfloat16)
    sched = sched_for(S, S, b, b, True, window, 0)
    idx = [torch.from_numpy(sched[n]) for n in ("kv_idx", "kv_cnt")]
    kw = dict(bq=b, bk=b, causal=True, window=window, q_offset=0, sk=S,
              scale=d ** -0.5, softcap=softcap, kv_groups=G)
    o, lse = tfa.flash_attention_plain(q, k, v, *idx, **kw)
    delta = (do.float() * o.float()).sum(-1)
    blocks = tfa._schedule_mask(*idx, Sp // b, "cpu")
    *want, rq, rk, rv, eq, ek, ev = tfa.flash_bwd_plain(q, k, v, do, lse, delta, blocks,
                                                        with_abs=True, **kw)
    if walk == "blocks":
        got = _flash_bwd_tiles(q, k, v, do, lse, delta, sched, b=b, window=window, G=G,
                               softcap=softcap, fault=fault)
    else:
        pair, n_split, dq_rows = PLANS[walk]
        got = _flash_bwd_planned(q, k, v, do, lse, delta, sched, kw, pair=pair,
                                 n_split=n_split, dq_rows=dq_rows, fault=fault)
    within = all(bool(((g.float() - w.float()).abs()
                       <= tfa.grad_error_bound(w, r, e)).all())
                 for g, w, r, e in zip(got, want, (rq, rk, rv), (eq, ek, ev)))
    assert within == (fault is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "skip_block", "wrong_block", "transpose"])
def test_matmul_bound_holds_and_catches_faults(fault, dtype):
    """``matmul_error_bound`` (the per-element check of K1/K2/K3 against
    their plain versions) holds for K2's own order of sums (CSR blocks in
    turn, 32-column slabs, f32) and fails for a skipped block, a wrong
    block id, or W read untransposed."""
    rng = np.random.default_rng(21)
    K, N, M = 64, 96, 48
    bm, _ = _topology(rng, K // BLOCK, N // BLOCK)
    dense = np.repeat(np.repeat(bm, BLOCK, 0), BLOCK, 1)
    w, _ = _as(rng.standard_normal((K, N)) * dense, dtype)
    g, _ = _as(rng.standard_normal((M, N)), dtype)
    ridx, rcnt = (torch.from_numpy(a) for a in pack_np(bm.T))
    want = tbsm.block_sparse_dx_plain(g, w, ridx, rcnt, BLOCK, BLOCK)
    absp = tbsm.block_sparse_dx_plain(g.abs().float(), w.abs().float(), ridx, rcnt, BLOCK, BLOCK)
    dx = torch.zeros(M, K)
    for kb in range(K // BLOCK):
        n = int(rcnt[kb]) - (1 if fault == "skip_block" and kb == 0 else 0)
        for s in range(n):
            nb = int(ridx[kb, s])
            if fault == "wrong_block" and kb == 0 and s == 0:
                nb = (nb + 1) % (N // BLOCK)
            wt = w[kb * BLOCK:(kb + 1) * BLOCK, nb * BLOCK:(nb + 1) * BLOCK].float()
            if fault == "transpose" and kb == 0:
                wt = wt.T
            for c in range(0, BLOCK, 8):
                dx[:, kb * BLOCK:(kb + 1) * BLOCK] += (
                    g[:, nb * BLOCK + c:nb * BLOCK + c + 8].float() @ wt[:, c:c + 8].T)
    dx = dx.to(want.dtype)
    bound = tbsm.matmul_error_bound(want, absp, N)
    assert bool(((dx.float() - want.float()).abs() <= bound).all()) == (fault is None)
