"""Port of the fused SGD wgrad epilogue on block-sparse weights (K7) and on
weight banks (K8 block-sparse, K20 masked) vs the JAX package's custom
VJPs: the forward, dx and the weight cotangent (the new momentum m_new =
mu * mom + x^T g + wd * w on the wgrad support) of
``fused_block_sparse_linear``, ``fused_grouped_block_sparse_linear`` and
``fused_grouped_masked_linear``, with and without the Top-KAST superset,
padded pack slots (a column with fewer blocks than the shared width) and a
group with no block; and K8 against K20 on one block-aligned mask.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels build and run only on the card: tests/test_torch_cuda.py holds
them against these plain versions); the JAX side runs its Pallas kernels
in interpret mode through ``jax.vjp``.  Inputs are made from a seed with
numpy and handed to both.  The fused train steps: the danube trajectory in
tests/test_torch_masked_train.py, qwen2-moe in tests/test_torch_moe_fused.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# Without sr (normal draws, mu 0.9, wd 1e-4), relative to the larger of 1
# and the largest magnitude: f32, the same products summed in another order
# plus one f32 rounding (XLA's CPU code may contract mu * mom + acc into a
# fused multiply-add, the port does not); a bf16 output rounds once on each
# side from f32 values that close, so at most one bf16 ulp apart (2**-7).
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
BLOCK = 16
BLK = (128, BLOCK, BLOCK)
SEED = 0xDEADBEEF  # the sign bit set: negative as the reference's int32
# (w dtype, mom dtype, sr): the training path's combinations (bf16 compute
# needs bf16 state, which rounds stochastically)
CASES = [("float32", "float32", False), ("float32", "bfloat16", True),
         ("bfloat16", "bfloat16", True), ("bfloat16", "bfloat16", False)]


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _exact(rng, shape, scale):
    """Values on a coarse grid (multiples of 2**-4 * scale below 2 * scale):
    with mu 0.5 and wd 2**-10 every f32 operation of m_new is exact on both
    sides, whatever the order of the sums or their contraction."""
    return (rng.integers(-24, 25, shape) * 2.0**-4 * scale).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _block_mask(rng, G, nkb, nnb, empty_group):
    """(G, nkb, nnb) blocks: column 0 all but one row (it sets the shared
    width), column 1 empty (every slot of it padded), the rest at 40%;
    ``empty_group`` has no block at all."""
    bm = rng.random((G, nkb, nnb)) < 0.4
    bm[:, :, 0] = True
    bm[:, -1, 0] = False
    bm[:, :, 1] = False
    if empty_group is not None:
        bm[empty_group] = False
    return bm


def _dense(bm):
    return np.repeat(np.repeat(bm, BLOCK, -2), BLOCK, -1)


def _problem(kernel, superset, rng):
    """(x, w, mom shapes' rows M, the forward mask A, the wgrad mask B or
    None): K7 one (64, 48) matrix at 20 rows; K8 a bank of 4 (64, 48)
    matrices at 13 rows an expert, expert 2 with no block, expert 3 with
    blocks but zero rows; K20 a bank of 4 (64, 40) matrices (N padded to
    48) with an elementwise mask, expert 1 fully masked."""
    if kernel == "K20":
        G, K, N, M = 4, 64, 40, 13
        a = rng.random((G, K, N)) < 0.3
        a[1] = False
        b = a | (rng.random(a.shape) < 0.15)
        b[1] = False
        return G, K, N, M, a, (b if superset else None)
    G = 1 if kernel == "K7" else 4
    bm = _block_mask(rng, G, 4, 3, None if kernel == "K7" else 2)
    sup = bm | (rng.random(bm.shape) < 0.3)
    sup[:, :, 1] = False
    if kernel == "K8":
        sup[2] = False
    a, b = _dense(bm), _dense(sup)
    M = 20 if kernel == "K7" else 13
    if kernel == "K7":
        a, b = a[0], b[0]
    return G, 64, 48, M, a, (b if superset else None)


def _run(kernel, case, superset, exact):
    wdt, mdt, sr = case
    rng = np.random.default_rng(2 * ("K7", "K8", "K20").index(kernel) + superset)
    G, K, N, M, a, b = _problem(kernel, superset, rng)
    wshape = a.shape
    lead = () if kernel == "K7" else (G,)
    support = a if b is None else b
    if exact:
        x = _exact(rng, (*lead, M, K), 1.0)
        g = _exact(rng, (*lead, M, N), 1.0)
        w = _exact(rng, wshape, 0.25) * support
        mom = _exact(rng, wshape, 0.5) * support
        kw = dict(mu=0.5, wd=2.0**-10, sr=sr)
    else:
        x = rng.standard_normal((*lead, M, K))
        g = rng.standard_normal((*lead, M, N))
        w = rng.standard_normal(wshape) / np.sqrt(K) * support
        mom = rng.standard_normal(wshape) * 0.1 * support
        kw = dict(mu=0.9, wd=1e-4, sr=sr)
    if kernel == "K8":
        x[3] = 0.0  # an expert with blocks but no rows: m_new = mu mom + wd w
    (xt, xj), (gt, gj), (wt, wj) = (_as(v, wdt) for v in (x, g, w))
    momt, momj = _as(mom, mdt)
    jseed = jnp.asarray(np.array([SEED], np.uint32).view(np.int32))
    if kernel == "K20":
        at, bt = torch.from_numpy(a), None if b is None else torch.from_numpy(b)
        aj, bj = jnp.asarray(a), None if b is None else jnp.asarray(b)
        t_fn = lambda xx, ww: tops.fused_grouped_masked_linear(
            xx, ww, at, momt, SEED, bwd_mask=bt, block=BLK, **kw)
        j_fn = lambda xx, ww: jops.fused_grouped_masked_linear(
            xx, ww, aj, momj, jseed, bwd_mask=bj, block=BLK, interpret=True, **kw)
    else:
        e = tpack.pack_entry(torch.from_numpy(a), (BLOCK, BLOCK),
                             bwd_mask=None if b is None else torch.from_numpy(b))
        assert bool((e["cnt"] < e["idx"].shape[-1]).any()), "no padded slot"
        je = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v for k, v in e.items()}
        t_op, j_op = ((tops.fused_block_sparse_linear, jops.fused_block_sparse_linear)
                      if kernel == "K7" else (tops.fused_grouped_block_sparse_linear,
                                              jops.fused_grouped_block_sparse_linear))
        t_fn = lambda xx, ww: t_op(xx, ww, momt, SEED, pack=e, block=BLK, **kw)
        j_fn = lambda xx, ww: j_op(xx, ww, momj, jseed, pack=je, block=BLK,
                                   interpret=True, **kw)
    xg, wg = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    y = t_fn(xg, wg)
    dx, m_new = torch.autograd.grad(y, (xg, wg), gt)
    jy, pull = jax.vjp(j_fn, xj, wj)
    jdx, jm_new = pull(gj)
    return y, dx, m_new, jy, jdx, jm_new, support, (wdt, mdt, sr), (w, mom, kw)


@pytest.mark.parametrize("superset", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["K7", "K8", "K20"])
def test_fused_wgrad_matches_jax(kernel, case, superset):
    """y, dx and the new momentum through the port's fused Functions
    against the reference's fused custom VJPs.  sr on: exact inputs, so
    the new momentum (sr included) agrees bit for bit; sr off: normal
    draws within ``TOL``.  m_new is exactly zero off the wgrad support, in
    w's dtype, on the bf16 grid with sr; the group with no block gets
    zeros, the expert with blocks but no rows mu * mom + wd * w."""
    sr = case[2]
    y, dx, m_new, jy, jdx, jm_new, support, (wdt, _, _), (w, mom, kw) = _run(
        kernel, case, superset, exact=sr)
    _close(y, jy, TOL[wdt], "y")
    _close(dx, jdx, TOL[wdt], "dx")
    assert m_new.dtype == TDT[wdt]
    if sr:
        np.testing.assert_array_equal(m_new.float().numpy(),
                                      np.asarray(jnp.asarray(jm_new, jnp.float32)))
        assert torch.equal(m_new.float(), m_new.to(torch.bfloat16).float())
    else:
        _close(m_new, jm_new, TOL[wdt], "m_new")
    assert not m_new[~torch.from_numpy(support)].any(), "m_new off the wgrad support"
    if kernel == "K8":
        assert not m_new[2].any(), "the group with no block"
        if not sr:
            want = kw["mu"] * torch.from_numpy(mom[3]).to(TDT[case[1]]).float() \
                + kw["wd"] * torch.from_numpy(w[3]).to(TDT[wdt]).float()
            assert torch.allclose(m_new[3].float(), want, rtol=TOL[wdt], atol=1e-7)
    if kernel == "K20":
        assert not m_new[1].any(), "the fully masked expert"


def test_fused_plain_versions_wrap_the_element_id():
    """The sr element id (g * K + row) * N + col wraps in uint32, as the
    reference's: ``_gid`` is exact in int64 and ``sr_to_bf16`` takes it mod
    2**32, which equals the wrapped product step by step; a bank past 2**32
    elements therefore repeats ids exactly 2**32 apart."""
    K, N = 3, 5
    ids = tmm._gid(K, N, "cpu", G=4)
    for g in range(4):
        for r in range(K):
            for c in range(N):
                want = (np.uint32(g) * np.uint32(K) + np.uint32(r)) * np.uint32(N) + np.uint32(c)
                assert int(ids[g, r, c]) % 2**32 == int(want)
    v = torch.linspace(-3, 3, 7)
    big = torch.arange(7, dtype=torch.int64) + 2**32 * 5
    assert torch.equal(tmm.sr_to_bf16(v, SEED, big),
                       tmm.sr_to_bf16(v, SEED, torch.arange(7, dtype=torch.int64)))


def test_k8_and_k20_agree_bit_for_bit_on_a_block_aligned_mask():
    """On one block-aligned mask (its superset too) the grouped
    block-sparse (K8) and grouped masked (K20) fused cotangents are the same
    function, sr's element ids included: bit for bit in each package, on
    normal draws (mu 0.9, wd 1e-4, sr on), up to the sign of a zero off the
    support (K20 multiplies by its mask, as the TPU kernel's source does,
    so a negative m_new there becomes -0.0; K8 never writes there: + 0.0
    turns -0.0 into 0.0); and the port's within one bf16 ulp of the
    reference's."""
    rng = np.random.default_rng(21)
    G, M, K, N = 3, 16, 64, 48
    bm = _block_mask(rng, G, K // BLOCK, N // BLOCK, empty_group=1)
    sup = bm | (rng.random(bm.shape) < 0.3)
    sup[1] = False
    a, b = _dense(bm), _dense(sup)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K) * b).astype(np.float32)
    mom = (rng.standard_normal((G, K, N)) * 0.1 * b).astype(np.float32)
    kw = dict(mu=0.9, wd=1e-4, sr=True)
    (xt, xj), (gt, gj), (wt, wj) = (_as(v, "float32") for v in (x, g, w))
    momt, momj = _as(mom, "bfloat16")
    jseed = jnp.asarray(np.array([SEED], np.uint32).view(np.int32))
    e = tpack.pack_entry(torch.from_numpy(a), (BLOCK, BLOCK), bwd_mask=torch.from_numpy(b))
    je = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v for k, v in e.items()}
    t_bs = tbsm.grouped_block_sparse_dw_fused_plain(
        xt, gt, e["bidx"], e["bcnt"], wt, momt, SEED, bk=BLOCK, bn=BLOCK, **kw)
    t_mm = tmm.grouped_masked_dw_fused_plain(xt, gt, torch.from_numpy(b), wt, momt, SEED,
                                             **kw)
    assert torch.equal(t_bs.view(torch.int32), (t_mm + 0.0).view(torch.int32))
    _, pull = jax.vjp(lambda xx, ww: jops.fused_grouped_block_sparse_linear(
        xx, ww, momj, jseed, pack=je, block=BLK, interpret=True, **kw), xj, wj)
    j_bs = pull(gj)[1]
    _, pull = jax.vjp(lambda xx, ww: jops.fused_grouped_masked_linear(
        xx, ww, jnp.asarray(a), momj, jseed, bwd_mask=jnp.asarray(b), block=BLK,
        interpret=True, **kw), xj, wj)
    j_mm = pull(gj)[1]
    np.testing.assert_array_equal(np.asarray(j_bs).view(np.uint32),
                                  (np.asarray(j_mm) + np.float32(0.0)).view(np.uint32))
    assert not t_bs[1].any() and bool(t_bs.any())
    # across the packages the sums run in another order: one bf16 ulp
    _close(t_bs, j_bs, 2.0**-7, "K8 port vs reference")
