"""Port masked-matmul Functions vs the JAX package's custom VJPs: the
forward, dx and dw of ``masked_linear`` and ``topkast_masked_linear``, the
fused SGD epilogue of ``fused_masked_linear`` (its weight cotangent is the
new momentum), the bit-exact ``sr_to_bf16`` and the epilogue's seed.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels K13, K14, K15 and K19 build and run only on the card); the JAX side
runs its Pallas kernels in interpret mode through ``jax.vjp``.  Inputs and
cotangents are made from a seed with numpy and handed to both.
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import masked_matmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# Relative to the largest magnitude compared.  f32: the same products summed
# in another order.  bf16: both sides accumulate in f32 and round once, so an
# output lands at most one bf16 ulp apart (2**-7).
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK = (16, 16, 16)
# (M, K, N): aligned; rows, K and N all off their tiles (K 40 -> 48, N 24
# -> 32 padded); a decode-like 4 rows
SHAPES = [(32, 48, 32), (7, 40, 24), (4, 32, 48)]


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _close(got_t, want_j, tol, what):
    got = got_t.detach().float().numpy()
    want = np.asarray(jnp.asarray(want_j, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _problem(rng, M, K, N, dtype, superset=False):
    """x, w, an elementwise mask A with an empty row and column, optionally
    a superset B ⊇ A, and the output cotangent."""
    m = rng.random((K, N)) < 0.3
    m[1, :] = False
    m[:, 2] = False
    out = {"x": _as(rng.standard_normal((M, K)), dtype),
           "w": _as(rng.standard_normal((K, N)) / np.sqrt(K), dtype),
           "g": _as(rng.standard_normal((M, N)), dtype),
           "m": (torch.from_numpy(m), jnp.asarray(m))}
    if superset:
        b = m | (rng.random((K, N)) < 0.15)
        out["b"] = (torch.from_numpy(b), jnp.asarray(b))
    return out


def _torch_vjp(fn, x, w, g):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    y = fn(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    return y.detach(), dx, dw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("topkast", [False, True])
def test_masked_linear_and_grads_match_jax(dtype, shape, topkast):
    """y = x @ (w * A); dx = g @ (w * A)^T; dw = (x^T g) * A, or * B under
    Top-KAST: forward and both cotangents as the reference's custom VJP,
    with padding of M, K and N and exact zeros off the wgrad mask."""
    M, K, N = shape
    p = _problem(np.random.default_rng(M + K + N + topkast), M, K, N, dtype, topkast)
    (xt, xj), (wt, wj), (gt, gj), (mt, mj) = p["x"], p["w"], p["g"], p["m"]
    if topkast:
        bt, bj = p["b"]
        tfn = lambda x, w: tops.topkast_masked_linear(x, w, mt, bt, block=BLOCK)
        jfn = lambda x, w: jops.topkast_masked_linear(x, w, mj, bj, block=BLOCK,
                                                      interpret=True)
    else:
        bt = mt
        tfn = lambda x, w: tops.masked_linear(x, w, mt, block=BLOCK)
        jfn = lambda x, w: jops.masked_linear(x, w, mj, block=BLOCK, interpret=True)
    y, dx, dw = _torch_vjp(tfn, xt, wt, gt)
    jy, vjp = jax.vjp(jfn, xj, wj)
    jdx, jdw = vjp(gj)
    assert y.dtype == dx.dtype == dw.dtype == TDT[dtype]
    _close(y, jy, TOL[dtype], "y")
    _close(dx, jdx, TOL[dtype], "dx")
    _close(dw, jdw, TOL[dtype], "dw")
    assert bool((dw[~bt] == 0).all()), "dw nonzero off the wgrad mask"


def test_mask_multiplies_not_selects():
    """An inf weight under a zero mask gives NaN (w * 0), as the reference's
    kernel bodies write it (``w * m.astype(w.dtype)``), in the forward and
    in dx; the wgrad mask multiplies a NaN gradient the same way.  (The
    reference's CPU interpret run is no yardstick here: XLA's simplifier
    turns its multiply by a converted bool into a select, giving 0.)"""
    w = torch.zeros(16, 16)
    w[3, 5] = float("inf")
    m = torch.ones(16, 16, dtype=torch.bool)
    m[3, 5] = False
    y = tops.masked_linear(torch.ones(16, 16), w, m, block=BLOCK)
    assert torch.isnan(y[:, 5]).all() and not torch.isnan(y[:, :5]).any()
    dx = tmm.masked_dx_plain(torch.ones(16, 16), w, m)
    assert torch.isnan(dx[:, 3]).all() and not torch.isnan(dx[:, 4:]).any()
    x = torch.ones(16, 16)
    x[0, 0] = float("nan")
    dw = tmm.masked_dw_plain(x, torch.ones(16, 16), ~m)
    assert torch.isnan(dw[0]).all()


def _exact(rng, shape, scale):
    """Values on a coarse grid (multiples of 2**-4 * scale below 2 * scale):
    their products and sums are exact in f32."""
    return (rng.integers(-24, 25, shape) * 2.0**-4 * scale).astype(np.float32)


@pytest.mark.parametrize("case", [
    # (w dtype, mom dtype, sr): the training path's combinations
    ("float32", "float32", False), ("float32", "bfloat16", True),
    ("bfloat16", "bfloat16", True), ("bfloat16", "bfloat16", False)])
@pytest.mark.parametrize("shape,superset", [((32, 48, 32), False), ((7, 40, 24), True)])
@pytest.mark.parametrize("exact", [True, False])
def test_fused_masked_linear_matches_jax(case, shape, superset, exact):
    """The weight cotangent of ``fused_masked_linear`` is m_new =
    (mu*mom + x^T g + wd*w) * wgm, trimmed back from the padded (Kp, Np);
    with sr stochastically rounded with the padded grid's ids and the seed.
    ``exact``: inputs on coarse grids and mu, wd powers of two, so every
    f32 operation of m_new is exact on both sides whatever their order or
    contraction, and m_new (sr included) agrees bit for bit.  Otherwise
    (mu 0.9, wd 1e-4, normal draws) XLA's CPU code may contract mu*mom + acc
    into one fused multiply-add: one f32 rounding apart, and with sr one
    bf16 ulp.  The forward and dx as ``masked_linear``."""
    wdt, mdt, sr = case
    M, K, N = shape
    rng = np.random.default_rng(M * K + N + superset)
    p = _problem(rng, M, K, N, wdt, superset)
    mt, mj = p["m"]
    bt, bj = p["b"] if superset else (None, None)
    if exact:
        (xt, xj), (gt, gj), (wt, wj) = (_as(_exact(rng, s_, sc), wdt) for s_, sc in
                                        (((M, K), 1.0), ((M, N), 1.0), ((K, N), 0.25)))
        momt, momj = _as(_exact(rng, (K, N), 0.5), mdt)
        kw = dict(mu=0.5, wd=2.0**-10, sr=sr)
    else:
        (xt, xj), (gt, gj), (wt, wj) = p["x"], p["g"], p["w"]
        momt, momj = _as(rng.standard_normal((K, N)) * 0.1, mdt)
        kw = dict(mu=0.9, wd=1e-4, sr=sr)
    seed = 0xDEADBEEF  # a seed with the sign bit set, as int32 it is negative
    y, dx, mnew = _torch_vjp(
        lambda x, w: tops.fused_masked_linear(x, w, mt, momt, seed, bwd_mask=bt,
                                              block=BLOCK, **kw), xt, wt, gt)
    jseed = jnp.asarray(np.array([seed], np.uint32).view(np.int32))
    jy, vjp = jax.vjp(lambda x, w: jops.fused_masked_linear(
        x, w, mj, momj, jseed, bwd_mask=bj, block=BLOCK, interpret=True, **kw), xj, wj)
    jdx, jmnew = vjp(gj)
    _close(y, jy, TOL[wdt], "y")
    _close(dx, jdx, TOL[wdt], "dx")
    assert mnew.dtype == TDT[wdt]
    if exact:
        np.testing.assert_array_equal(mnew.float().numpy(),
                                      np.asarray(jnp.asarray(jmnew, jnp.float32)))
    else:
        _close(mnew, jmnew, TOL["bfloat16" if sr else wdt], "m_new")
    off = ~(mt if bt is None else bt)
    assert bool((mnew[off] == 0).all())
    if sr:  # on the bf16 grid
        assert torch.equal(mnew.float(), mnew.to(torch.bfloat16).float())


def test_sr_to_bf16_bit_identical():
    """sr_to_bf16 bit for bit against the reference: random values over
    many binades, signed zeros, subnormals, inf, -inf, NaN, all-ones
    mantissas (the carry into the exponent, up to inf from the largest
    finite value), seeds with the sign bit set and ids past 2**31."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4000) * np.exp2(rng.integers(-30, 30, 4000))).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-39,
                         np.finfo(np.float32).max, -np.finfo(np.float32).max],
                        np.float32)
    ones = np.array([0x3F7FFFFF, 0x3FFFFFFF, 0xBF7FFFFF, 0x7F7FFFFF, 0x007FFFFF],
                    np.uint32).view(np.float32)
    v = np.concatenate([v, specials, ones])
    gid = rng.integers(0, 2**32, v.size, dtype=np.uint64).astype(np.uint32)
    gid[:8] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 7, 123456789, 3000000000]
    exp = lambda bits: (bits >> 23) & 0xFF
    carried = 0
    for seed in (0, 12345, -1, -2**31, 2**31 - 1):
        want = np.asarray(jmm.sr_to_bf16(jnp.asarray(v), jnp.int32(seed),
                                         jnp.asarray(gid))).view(np.uint32)
        got = tmm.sr_to_bf16(torch.from_numpy(v), seed,
                             torch.from_numpy(gid.astype(np.int64))).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert not (got & 0xFFFF)[np.isfinite(v)].any()
        carried += int((exp(got[-5:]) != exp(ones.view(np.uint32))).sum())
    assert carried, "no all-ones mantissa carried into its exponent"


def test_fused_dw_plain_sr_uses_the_padded_width():
    """K19's gid is row * N + col with N the width the kernel sees: the
    plain version's ids on a (K, N) array match the reference's formula
    (k * bk + row) * ncols + (n * bn + col) over any tiling."""
    K, N = 48, 32
    gid = tmm._gid(K, N, "cpu").numpy()
    bk, bn = 16, 16
    for k in range(K // bk):
        for n in range(N // bn):
            rows, cols = np.meshgrid(np.arange(bk), np.arange(bn), indexing="ij")
            want = ((k * bk + rows) * N + (n * bn + cols)).astype(np.int64)
            np.testing.assert_array_equal(gid[k * bk:(k + 1) * bk, n * bn:(n + 1) * bn], want)
