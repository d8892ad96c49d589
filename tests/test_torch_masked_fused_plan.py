"""K19/K20's launch plan and its split, on the CPU.  The masked fused SGD
wgrad runs the masked wgrad's walk on the GEMM core (K15/K18's) with the
momentum epilogue at the store, and takes the wgrad's plan on the fused
kernel's own resident CTAs (``fwd_plan`` with ``entry="dw_fused"``: rows =
K, L = M, cols = N, always 128 rows, and unlike K15/K18 the 128 x 128 tile
for a one-slab walk in bf16): its picks at the training paths' shapes
(given as numbers), the
plain version that follows a split (``masked_dw_fused_split_plain``: f32
partials over whole M slabs, summed in split order, then the epilogue --
the momentum, the mask, sr -- rounded once) against the unsplit plain
version within ``fused_error_bound`` (bit for bit unsplit) and against the
reference's Pallas kernels (``_dw_fused_call``, ``_g_dw_fused_call``) in
interpret mode, the sr ids equal, and NaN where an inf in x lies under a
zero wgrad mask.

The CUDA kernel runs only on a card: tests/test_torch_cuda.py forces every
candidate plan there and holds each against these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import masked_matmul as jmm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
# CTAs resident per SM of the fused kernel's 128-row tiles (the H100 build's
# occupancy, the masked wgrad's; the wrapper reads it from the runtime)
CTAS = {BF: 2, F32: 1}
MU, WD, SEED = 0.9, 1e-4, 0x9E3779B9  # a seed with the sign bit set


def _plan(Mp, K, N, G, dt, bn=128):
    """The fused wgrad's plan of x (G, Mp, K)^T @ g (G, Mp, N): rows K,
    contraction Mp, columns N."""
    return tmm.fwd_plan(K, Mp, N, G, dt, SMS * CTAS[dt], bn_limit=bn, entry="dw_fused")


# the 2-D fused wgrad shapes of the training paths at 2048 rows, m_new (K,
# N) and its dtype (attention in bf16, the MLP in f32), with the plan's
# pick: the split only where the unsplit grid fills less than one wave --
# danube's wk and wv (100 CTAs on 264 slots)
FUSED_2048 = {
    "danube attn wq/wo": ((2560, 2560, BF), (128, 128, 1)),
    "danube attn wk/wv": ((2560, 640, BF), (128, 128, 2)),
    "danube mlp wi/wg": ((2560, 6912, F32), (128, 128, 1)),
    "danube mlp wo": ((6912, 2560, F32), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(FUSED_2048))
def test_fused_plan_at_the_training_shapes(name):
    """At 2048 rows K19 takes the 128 x 128 tile over (K, N) and splits M in
    two exactly where the grid alone leaves most slots empty; every
    candidate a sweep forces is a built wgrad tile, the pick among them."""
    (K, N, dt), want = FUSED_2048[name]
    assert _plan(2048, K, N, 1, dt) == want
    ctas = -(-K // 128) * -(-N // 128)
    if want[2] == 2:
        assert ctas < SMS * CTAS[dt] // 2, ctas
    cands = tmm.fwd_candidates(K, 2048, N, 1, dt, SMS * CTAS[dt], entry="dw_fused")
    assert want in cands and all((bm, bn) in tmm.DW_TILES for bm, bn, _ in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_fused_plan_keeps_the_banks_whole(dt):
    """qwen2-moe's 60-expert banks (wi 2048 x 1408, wo 1408 x 2048) at C =
    256 (a 2048-token microbatch's 171 rows, padded) and 16 rows: 10560
    CTAs of 128 x 128, never split, the 16-row walk (one slab) in bf16 too
    (K18 halves its tile there; K20's store streams mom and w better on
    the full tile)."""
    for K, N in ((2048, 1408), (1408, 2048)):
        assert _plan(256, K, N, 60, dt) == (128, 128, 1), (K, N)
        assert _plan(16, K, N, 60, dt) == (128, 128, 1), (K, N)


@pytest.mark.parametrize("dt", [BF, F32])
@pytest.mark.parametrize("Mp", [16, 32, 48, 256, 2048])
def test_fused_plan_is_the_wgrad_plan_but_for_one_slab_in_bf16(dt, Mp):
    """On the same slots the fused wgrad's plan is K15/K18's at every shape
    (the same walk; only the store and the merge's epilogue differ) but a
    one-slab walk (Mp <= 32) in bf16, where K15/K18 take the 128 x 64 tile
    and K19/K20 the 128 x 128; its tile is a wgrad's, 128 rows whatever K,
    and the sweeps' candidates hold its pick."""
    for K, N, G in ((2560, 2560, 1), (2560, 640, 1), (1408, 2048, 60), (64, 96, 3)):
        slots = SMS * CTAS[dt]
        got = tmm.fwd_plan(K, Mp, N, G, dt, slots, entry="dw_fused")
        dw = tmm.fwd_plan(K, Mp, N, G, dt, slots, entry="dw")
        one_slab_bf16 = dt == BF and Mp <= tmm.FWD_SLAB
        assert got == ((128, 128, 1) if one_slab_bf16 else dw), (K, N, G)
        assert dw == ((128, 64, 1) if one_slab_bf16 else got), (K, N, G)
        cands = tmm.fwd_candidates(K, Mp, N, G, dt, slots, entry="dw_fused")
        assert got in cands and all((bm, bn) in tmm.DW_TILES for bm, bn, _ in cands)
    assert tmm.fwd_tile(64, entry="dw_fused") == (128, 128)


def _inputs(rng, G, M, K, N, dtype, rows=None):
    """x (G, M, K) and g (G, M, N) (rows past ``rows`` zero: the wrapper's
    padding) in dtype, w in dtype, mom in bf16, and a wgrad mask with an
    empty row and column, from numpy."""
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = (rng.standard_normal((G, M, N)) / np.sqrt(M)).astype(np.float32)
    if rows is not None:
        x[:, rows:] = 0.0
        g[:, rows:] = 0.0
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    mom = (0.1 * rng.standard_normal((G, K, N))).astype(np.float32)
    m = rng.random((G, K, N)) < 0.3
    m[:, 1, :] = False
    m[:, :, 2] = False
    t = lambda a, d: torch.from_numpy(a).to(d)
    return t(x, dtype), t(g, dtype), t(w, dtype), t(mom, BF), torch.from_numpy(m)


def _kw(sr):
    return dict(mu=MU, wd=WD, sr=sr)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("shape", [(1, 16, 48, 80), (1, 96, 64, 128), (3, 48, 32, 144)])
def test_dw_fused_split_plain_matches_the_plain_version(dtype, shape):
    """Every split count (1 to every M slab its own split) within
    ``fused_error_bound`` of the unsplit plain version (bit for bit
    unsplit), sr off, 2-D and grouped, zeros off the mask; with sr every
    split is bit for bit ``sr_to_bf16`` of its own f32 m_new; ``dw_fused_merge``
    on CPU tensors is the same ordered sum and epilogue, and counts no
    launch."""
    G, M, K, N = shape
    x, g, w, mom, m = _inputs(np.random.default_rng(61), G, M, K, N, dtype)
    if G == 1:
        x, g, w, mom, m = x[0], g[0], w[0], mom[0], m[0]
    want = tmm.masked_dw_fused_plain(x, g, m, w, mom, SEED, **_kw(False))
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, MU, WD, mom, w, acc, m)
    gid = tmm._gid(K, N, "cpu", G=G if G > 1 else None)
    for n_split in range(1, -(-M // tmm.FWD_SLAB) + 1):
        got = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split, **_kw(False))
        assert got.dtype == dtype and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        assert not got[~m].any()
        raw = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split,
                                              out_dtype=F32, **_kw(False))
        sr = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split, **_kw(True))
        assert torch.equal(sr, tmm.sr_to_bf16(raw, SEED, gid).to(dtype)), n_split
        part = torch.stack([x.float()[..., a:b, :].transpose(-1, -2) @ g.float()[..., a:b, :]
                            for a, b in tmm.fwd_split_ranges(M, n_split)])
        n0 = tmm.dw_fused_merge_launches
        for s_r, expect in ((False, got), (True, sr)):
            merged = tmm.dw_fused_merge(part, m, w, mom, torch.empty(want.shape, dtype=dtype),
                                        SEED, **_kw(s_r))
            assert torch.equal(merged, expect), (n_split, s_r)
        assert tmm.dw_fused_merge_launches == n0


# relative to the largest magnitude, as tests/test_torch_masked.py states:
# f32 the same products summed in another order
TOL = 1e-5
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", [
    # (G, M, K, N, real rows, n_split): 4 rows padded to 16 (half a slab);
    # 40 rows padded to 48 (1.5 slabs) split in two; a grouped bank at 48
    (1, 16, 48, 80, 4, 1), (1, 48, 64, 96, 40, 2), (3, 48, 32, 96, 37, 2)])
def test_dw_fused_split_plain_matches_the_reference_kernel(dtype, case):
    """The split plain version against the reference's Pallas fused wgrad
    (``_dw_fused_call``, or ``_g_dw_fused_call`` on a bank) in interpret
    mode, on the same numpy inputs: the raw new momentum (sr off, f32 w on
    the reference's side, holding the same values, so that its output is
    f32) within f32 tolerance; the reference's sr result bit for bit
    ``sr_to_bf16`` of its own raw output on the port's element ids (the
    padded extents' (g * K + row) * N + col), and the port's likewise."""
    G, M, K, N, rows, n_split = case
    x, g, w, mom, m = _inputs(np.random.default_rng(67), G, M, K, N, dtype, rows)
    j = lambda t, d=None: jnp.asarray(t.float().numpy(), d or JDT[dtype])
    jseed = jnp.asarray(np.array([SEED], np.uint32).view(np.int32))
    gid = tmm._gid(K, N, "cpu", G=G if G > 1 else None)
    if G == 1:
        x, g, w, mom, m = x[0], g[0], w[0], mom[0], m[0]
        call = jmm._dw_fused_call
    else:
        call = jmm._g_dw_fused_call
    ref = lambda sr: torch.from_numpy(np.array(call(
        j(x), j(g), jnp.asarray(m.numpy()), j(w, jnp.float32), j(mom, jnp.bfloat16), jseed,
        MU, WD, sr, 16, 16, 16, True)))
    want = ref(False)
    raw = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split, out_dtype=F32,
                                          **_kw(False))
    assert raw.shape == want.shape and want.dtype == F32
    err = float((raw - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err
    assert torch.equal(ref(True), tmm.sr_to_bf16(want, SEED, gid))
    sr = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split, **_kw(True))
    assert torch.equal(sr, tmm.sr_to_bf16(raw, SEED, gid).to(dtype))


@pytest.mark.parametrize("dtype", [F32, BF])
def test_dw_fused_split_plain_inf_under_zero_mask_is_nan(dtype):
    """The wgrad mask multiplies the new momentum, never selects: an inf in
    x (row r, column k) gives NaN in m_new's row k wherever the mask is 0
    and +-inf where it is 1, in the split plain version as in the unsplit
    one, 2-D and grouped, sr off and on (sr passes non-finite values
    through)."""
    G, M, K, N = 2, 80, 32, 96
    x, g, w, mom, m = _inputs(np.random.default_rng(71), G, M, K, N, dtype)
    x[0, 37, 5] = float("inf")
    for sr in (False, True):
        want = tmm.masked_dw_fused_plain(x, g, m, w, mom, SEED, **_kw(sr))
        assert torch.equal(torch.isnan(want[0, 5]), ~m[0, 5])
        assert torch.equal(torch.isinf(want[0, 5]), m[0, 5])
        assert int(torch.isnan(want).sum()) == int((~m[0, 5]).sum())
        for n_split in (1, 2, 3):
            got = tmm.masked_dw_fused_split_plain(x, g, m, w, mom, SEED, n_split, **_kw(sr))
            assert torch.equal(torch.isnan(got), torch.isnan(want)), n_split
            assert torch.equal(torch.isinf(got), torch.isinf(want)), n_split
            got2 = tmm.masked_dw_fused_split_plain(x[0], g[0], m[0], w[0], mom[0], SEED,
                                                   n_split, **_kw(sr))
            assert torch.equal(torch.isnan(got2), torch.isnan(want[0])), n_split
