"""K15/K18's launch plan and its split, on the CPU.  The masked wgrad runs
on the GEMM core of the forward and the dgrad and takes their plan
(``fwd_plan`` on rows x contraction -> rows x cols with ``entry="dw"``:
rows = K, L = M, cols = N, always 128 rows, and the 128 x 64 tile for a
one-slab walk in bf16): its picks at the training paths' wgrad shapes (given as numbers), the
plain version that follows a split (``masked_dw_split_plain``:
f32 partials over whole M slabs, summed in split order, then times the
mask, rounded once) against the unsplit plain version within
``matmul_error_bound`` (bit for bit unsplit) and against the reference's
Pallas wgrad (``_dw_call``, ``_g_dw_call``) in interpret mode, and NaN
where an inf in x lies under a zero mask.  The forward's and the dgrad's
picks are held unchanged by tests/test_torch_masked_dx_plan.py.

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
# CTAs resident per SM of the 128-row tile (the H100 build's occupancy, as
# the forward's; the wrapper reads it from the runtime)
CTAS = {BF: 2, F32: 1}


def _dw_plan(Mp, K, N, G, dt, bn=128):
    """The wgrad's plan of x (G, Mp, K)^T @ g (G, Mp, N): rows K,
    contraction Mp, columns N."""
    return tmm.fwd_plan(K, Mp, N, G, dt, SMS * CTAS[dt], bn_limit=bn, entry="dw")


# the 2-D wgrad shapes of the training paths at 2048 rows, dw (K, N) and
# its dtype (attention in bf16, the MLP in f32), with the plan's pick: the
# split only where the unsplit grid (ceil(K / 128) ceil(N / 128) CTAs)
# fills less than one wave -- danube's wk and wv (100 CTAs on 264 slots)
DW_2048 = {
    "danube attn wq/wo": ((2560, 2560, BF), (128, 128, 1)),
    "danube attn wk/wv": ((2560, 640, BF), (128, 128, 2)),
    "danube mlp wi/wg": ((2560, 6912, F32), (128, 128, 1)),
    "danube mlp wo": ((6912, 2560, F32), (128, 128, 1)),
    "qwen2-moe attn": ((2048, 2048, BF), (128, 128, 1)),
    "qwen2-moe shared wi/wg": ((2048, 5632, F32), (128, 128, 1)),
    "qwen2-moe shared wo": ((5632, 2048, F32), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(DW_2048))
def test_dw_plan_at_the_training_shapes(name):
    """At 2048 rows the wgrad takes the 128 x 128 tile over (K, N) and
    splits M in two exactly where the grid alone leaves most slots empty;
    every candidate a sweep forces is a built tile, the pick among them."""
    (K, N, dt), want = DW_2048[name]
    assert _dw_plan(2048, K, N, 1, dt) == want
    ctas = -(-K // 128) * -(-N // 128)
    if want[2] == 2:
        assert ctas < SMS * CTAS[dt] // 2, ctas
    cands = tmm.fwd_candidates(K, 2048, N, 1, dt, SMS * CTAS[dt], entry="dw")
    assert want in cands and all((bm, bn) in tmm.DW_TILES for bm, bn, _ in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_dw_plan_keeps_the_banks_whole(dt):
    """qwen2-moe's 60-expert banks (wi 2048 x 1408, wo 1408 x 2048) at C =
    256 (a 2048-token microbatch's 171 rows, padded) and 16 rows: 10560
    CTAs of 128 x 128, never split, except that the 16-row walk (one slab)
    takes the 128 x 64 tile in bf16; a caller's column tile below 128 caps
    the tile at 64."""
    for K, N in ((2048, 1408), (1408, 2048)):
        assert _dw_plan(256, K, N, 60, dt) == (128, 128, 1), (K, N)
        assert _dw_plan(16, K, N, 60, dt) == (128, 64 if dt == BF else 128, 1), (K, N)
        assert _dw_plan(256, K, N, 60, dt, bn=16) == (128, 64, 1), (K, N)


@pytest.mark.parametrize("dt", [BF, F32])
@pytest.mark.parametrize("Mp", [16, 32, 48, 256, 2048])
def test_dw_plan_is_the_forward_plan_but_for_one_slab_in_bf16(dt, Mp):
    """The wgrad's plan is the forward's on (K, Mp, N) at every shape whose
    K has more than 64 rows, but a walk of one slab (Mp <= 32) in bf16,
    where it keeps the split and halves the column tile; at K <= 64 it
    keeps 128 rows (no 16-row wgrad tile is built); the sweeps' candidates
    hold its pick and only built wgrad tiles."""
    for K, N, G in ((2560, 2560, 1), (2560, 640, 1), (1408, 2048, 60), (256, 96, 3)):
        slots = SMS * CTAS[dt]
        got, fwd = _dw_plan(Mp, K, N, G, dt), tmm.fwd_plan(K, Mp, N, G, dt, slots)
        one_slab_bf16 = dt == BF and Mp <= tmm.FWD_SLAB
        assert got == ((fwd[0], 64, fwd[2]) if one_slab_bf16 else fwd), (K, N, G)
        cands = tmm.fwd_candidates(K, Mp, N, G, dt, slots, entry="dw")
        assert got in cands and all((bm, bn) in tmm.DW_TILES for bm, bn, _ in cands)
    assert tmm.fwd_tile(64, entry="dw") == (128, 128) and tmm.fwd_tile(64) == (16, 64)
    assert _dw_plan(Mp, 64, 96, 1, dt)[:2] == (128, 64 if dt == BF and Mp <= 32 else 128)


def _inputs(rng, G, M, K, N, dtype, rows=None):
    """x (G, M, K) and g (G, M, N) (rows past ``rows`` zero: the wrapper's
    padding), and a mask of dw's shape with an empty row and column, as
    numpy f32 rounded to dtype."""
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = (rng.standard_normal((G, M, N)) / np.sqrt(M)).astype(np.float32)
    if rows is not None:
        x[:, rows:] = 0.0
        g[:, rows:] = 0.0
    m = rng.random((G, K, N)) < 0.3
    m[:, 1, :] = False
    m[:, :, 2] = False
    t = lambda a: torch.from_numpy(a).to(dtype)
    return t(x), t(g), torch.from_numpy(m)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("shape", [(1, 16, 48, 80), (1, 96, 64, 128), (3, 48, 32, 144)])
def test_dw_split_plain_matches_the_plain_version(dtype, shape):
    """Every split count (1 to every M slab its own split) within
    ``matmul_error_bound`` of the unsplit plain version (bit for bit
    unsplit), 2-D and grouped; ``dw_merge`` on CPU tensors is the same
    ordered sum, masked after it."""
    G, M, K, N = shape
    x, g, m = _inputs(np.random.default_rng(41), G, M, K, N, dtype)
    if G == 1:
        x, g, m = x[0], g[0], m[0]
    want = (tmm.masked_dw_plain if G == 1 else tmm.grouped_masked_dw_plain)(x, g, m)
    absp = (x.float().abs().transpose(-1, -2) @ g.float().abs()) * m
    bound = tmm.matmul_error_bound(want, absp, M)
    for n_split in range(1, -(-M // tmm.FWD_SLAB) + 1):
        got = tmm.masked_dw_split_plain(x, g, m, n_split)
        assert got.dtype == dtype and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        assert not got[~m].any()
        part = torch.stack([x.float()[..., a:b, :].transpose(-1, -2) @ g.float()[..., a:b, :]
                            for a, b in tmm.fwd_split_ranges(M, n_split)])
        n0 = tmm.dw_merge_launches
        merged = tmm.dw_merge(part, m, torch.empty(want.shape, dtype=dtype))
        assert torch.equal(merged, got) and tmm.dw_merge_launches == n0


# relative to the largest magnitude, as tests/test_torch_masked.py states:
# f32 the same products summed in another order; bf16 one ulp
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", [
    # (G, M, K, N, real rows, n_split): 4 rows padded to 16 (half a slab);
    # 40 rows padded to 48 (1.5 slabs) split in two; a grouped bank at 48
    (1, 16, 48, 80, 4, 1), (1, 48, 64, 96, 40, 2), (3, 48, 32, 96, 37, 2)])
def test_dw_split_plain_matches_the_reference_kernel(dtype, case):
    """The split plain version against the reference's Pallas wgrad
    (``_dw_call``, or ``_g_dw_call`` on a bank) in interpret mode, on the
    same numpy inputs."""
    G, M, K, N, rows, n_split = case
    x, g, m = _inputs(np.random.default_rng(43), G, M, K, N, dtype, rows)
    j = lambda t: jnp.asarray(t.float().numpy(), JDT[dtype])
    if G == 1:
        got = tmm.masked_dw_split_plain(x[0], g[0], m[0], n_split)
        want = jmm._dw_call(j(x[0]), j(g[0]), jnp.asarray(m[0].numpy()), 16, 16, 16, True,
                            JDT[dtype])
    else:
        got = tmm.masked_dw_split_plain(x, g, m, n_split)
        want = jmm._g_dw_call(j(x), j(g), jnp.asarray(m.numpy()), 16, 16, 16, True,
                              JDT[dtype])
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert got.shape == want.shape
    assert err <= TOL[dtype] * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("dtype", [F32, BF])
def test_dw_split_plain_inf_under_zero_mask_is_nan(dtype):
    """The mask multiplies the sum, never selects: an inf in x (row r,
    column k) gives NaN in the split plain version in exactly the unsplit
    one's places -- dw's row k wherever its mask is 0 -- 2-D and grouped;
    a NaN in g gives NaN down dw's column, under a one and a zero alike."""
    G, M, K, N = 2, 80, 32, 96
    x, g, m = _inputs(np.random.default_rng(47), G, M, K, N, dtype)
    x[0, 37, 5] = float("inf")
    g[1, 60, 70] = float("nan")
    want = torch.isnan(tmm.grouped_masked_dw_plain(x, g, m))
    assert torch.equal(want[0, 5], ~m[0, 5]) and bool(want[1, :, 70].all())
    assert int(want.sum()) == int((~m[0, 5]).sum()) + K
    for n_split in (1, 2, 3):
        got = tmm.masked_dw_split_plain(x, g, m, n_split)
        assert torch.equal(torch.isnan(got), want), n_split
        got2 = tmm.masked_dw_split_plain(x[0], g[0], m[0], n_split)
        assert torch.equal(torch.isnan(got2), torch.isnan(tmm.masked_dw_plain(x[0], g[0], m[0])))
