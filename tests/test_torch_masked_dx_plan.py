"""K14/K17's launch plan and its split, on the CPU.  The masked dgrad runs
on the forward's GEMM core and takes the forward's plan (``fwd_plan`` on
rows x contraction -> rows x cols, with L = N and cols = K): its picks at
the training paths' dgrad shapes (given as numbers), the forward's picks
unchanged at every shape of tests/test_torch_masked_fwd_plan.py, the plain
version that follows a split (``masked_dx_split_plain``: f32 partials over
whole N slabs, summed in split order, rounded once) against the unsplit
plain version within ``matmul_error_bound`` and against the reference's
Pallas dgrad (``_dx_call``, ``_g_dx_call``) in interpret mode, and NaN
where an inf weight lies under a zero mask.

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
# CTAs resident per SM of each row tile, the forward's and the dgrad's
# kernels alike (the H100 build's occupancy; the wrapper reads it from the
# runtime)
CTAS = {(BF, 16): 6, (F32, 16): 4, (BF, 128): 2, (F32, 128): 1}


def _slots(dtype, Mp):
    return SMS * CTAS[(dtype, tmm.fwd_tile(Mp)[0])]


def _dx_plan(Mp, K, N, G, dt, bk=128):
    """The dgrad's plan of g (G, Mp, N) @ (w * m)^T, w (G, K, N)."""
    return tmm.fwd_plan(Mp, N, K, G, dt, _slots(dt, Mp), bn_limit=bk)


# the 2-D dgrad shapes of the training paths at 2048 rows, w (K, N) and its
# dtype (attention in bf16, the MLP in f32), with the plan's pick: the
# split where the unsplit grid (ceil(2048 / 128) ceil(K / 128) CTAs) leaves
# its last wave mostly idle -- danube's wq (320 CTAs on 264 slots) and its
# f32 wi and wg (320 on 132; the forward's wo in the dgrad's direction)
DX_2048 = {
    "danube attn wq/wo": ((2560, 2560, BF), (128, 128, 2)),
    "danube attn wk/wv": ((2560, 640, BF), (128, 128, 1)),
    "danube mlp wi/wg": ((2560, 6912, F32), (128, 128, 2)),
    "danube mlp wo": ((6912, 2560, F32), (128, 128, 1)),
    "qwen2-moe attn": ((2048, 2048, BF), (128, 128, 1)),
    "qwen2-moe shared wi/wg": ((2048, 5632, F32), (128, 128, 1)),
    "qwen2-moe shared wo": ((5632, 2048, F32), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(DX_2048))
def test_dx_plan_at_the_training_shapes(name):
    """At 2048 rows the dgrad takes the 128 x 128 tile and splits N in two
    exactly where the waves say so; every candidate a sweep forces is a
    built tile, the pick among them."""
    (K, N, dt), want = DX_2048[name]
    assert _dx_plan(2048, K, N, 1, dt) == want
    ctas = 16 * -(-K // 128)
    slots = _slots(dt, 2048)
    if want[2] == 2:  # the unsplit grid's last wave at most 3/4 full
        assert 0 < ctas % slots <= 3 * slots // 4, (ctas, slots)
    cands = tmm.fwd_candidates(2048, N, K, 1, dt, slots)
    assert want in cands and all((bm, bn) in tmm.FWD_TILES for bm, bn, _ in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_dx_plan_keeps_the_banks_whole(dt):
    """qwen2-moe's 60-expert banks (wi 2048 -> 1408, wo 1408 -> 2048) at C
    = 256 (a 2048-token microbatch's 171 rows, padded) and 16 rows: 960 to
    1920 CTAs, never split; a caller's column tile below 128 caps the tile
    at 64."""
    for K, N in ((2048, 1408), (1408, 2048)):
        assert _dx_plan(256, K, N, 60, dt) == (128, 128, 1), (K, N)
        assert _dx_plan(16, K, N, 60, dt) == (16, 64, 1), (K, N)
        assert _dx_plan(256, K, N, 60, dt, bk=16) == (128, 64, 1), (K, N)


# K13/K16's picks at every shape of tests/test_torch_masked_fwd_plan.py,
# (Mp, K, N, G, bn_limit): (bf16 plan, f32 plan), taken before the plan
# served the dgrad too
FWD_PICKS = {
    (16, 2560, 2560, 1, 128): ((16, 64, 15), (16, 64, 13)),
    (16, 2560, 640, 1, 128): ((16, 64, 15), None),
    (16, 2560, 6912, 1, 128): (None, (16, 64, 4)),
    (16, 6912, 2560, 1, 128): ((16, 64, 19), (16, 64, 13)),
    (16, 12288, 12288, 1, 128): ((16, 64, 4), None),
    (16, 12288, 1024, 1, 128): ((16, 64, 32), None),
    (16, 12288, 28672, 1, 128): (None, (16, 64, 1)),
    (16, 28672, 12288, 1, 128): (None, (16, 64, 2)),
    (16, 2048, 2048, 1, 128): ((16, 64, 12), None),
    (16, 2048, 5632, 1, 128): (None, (16, 64, 6)),
    (16, 5632, 2048, 1, 128): (None, (16, 64, 16)),
    (16, 2048, 1408, 60, 128): ((16, 64, 1), (16, 64, 1)),
    (96, 2048, 1408, 60, 128): ((128, 128, 1), (128, 128, 1)),
    (256, 2048, 1408, 60, 128): ((128, 128, 1), (128, 128, 1)),
    (16, 1408, 2048, 60, 128): ((16, 64, 1), (16, 64, 1)),
    (96, 1408, 2048, 60, 128): ((128, 128, 1), (128, 128, 1)),
    (256, 1408, 2048, 60, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 2560, 2560, 1, 128): ((128, 128, 2), (128, 128, 2)),
    (2048, 2560, 640, 1, 128): ((128, 128, 2), (128, 128, 1)),
    (2048, 2560, 6912, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 6912, 2560, 1, 128): ((128, 128, 2), (128, 128, 2)),
    (16, 16, 2560, 1, 128): ((16, 64, 1), (16, 64, 1)),
    (2048, 16, 2560, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (16, 48, 2560, 1, 128): ((16, 64, 1), (16, 64, 1)),
    (2048, 48, 2560, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (16, 80, 2560, 1, 128): ((16, 64, 1), (16, 64, 1)),
    (2048, 80, 2560, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 256, 64, 1, 16): ((128, 64, 2), (128, 64, 2)),
}


# K14/K17's picks, (Mp, K, N, G, bn_limit): (bf16 plan, f32 plan), taken
# before the plan served the wgrad too
DX_PICKS = {
    (2048, 2560, 2560, 1, 128): ((128, 128, 2), (128, 128, 2)),
    (2048, 2560, 640, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 2560, 6912, 1, 128): ((128, 128, 2), (128, 128, 2)),
    (2048, 6912, 2560, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 2048, 2048, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 2048, 5632, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (2048, 5632, 2048, 1, 128): ((128, 128, 1), (128, 128, 1)),
    (256, 2048, 1408, 60, 128): ((128, 128, 1), (128, 128, 1)),
    (16, 2048, 1408, 60, 128): ((16, 64, 1), (16, 64, 1)),
    (256, 1408, 2048, 60, 16): ((128, 64, 1), (128, 64, 1)),
}


@pytest.mark.parametrize("dt", [BF, F32])
def test_fwd_picks_are_unchanged(dt):
    """The plan that now serves the three directions picks for K13 and K16
    exactly what it picked before, at every forward shape, and for K14 and
    K17 what it picked before it served the wgrad."""
    col = 0 if dt == BF else 1
    for (Mp, K, N, G, bn_limit), picks in FWD_PICKS.items():
        if picks[col] is not None:
            got = tmm.fwd_plan(Mp, K, N, G, dt, _slots(dt, Mp), bn_limit=bn_limit)
            assert got == picks[col], (Mp, K, N, G, bn_limit)
    for (Mp, K, N, G, bn_limit), picks in DX_PICKS.items():
        assert _dx_plan(Mp, K, N, G, dt, bk=bn_limit) == picks[col], (Mp, K, N, G, bn_limit)


def _inputs(rng, G, M, K, N, dtype, rows=None):
    """g (G, M, N) (rows past ``rows`` zero: the wrapper's padding), w (G,
    K, N), and a mask with an empty row and column, as numpy f32 rounded to
    dtype."""
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    if rows is not None:
        g[:, rows:] = 0.0
    w = (rng.standard_normal((G, K, N)) / np.sqrt(N)).astype(np.float32)
    m = rng.random((G, K, N)) < 0.3
    m[:, 1, :] = False
    m[:, :, 2] = False
    t = lambda a: torch.from_numpy(a).to(dtype)
    return t(g), t(w), torch.from_numpy(m)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("shape", [(1, 16, 48, 80), (1, 32, 64, 256), (3, 16, 32, 144)])
def test_dx_split_plain_matches_the_plain_version(dtype, shape):
    """Every split count (1 to every N slab its own split) within
    ``matmul_error_bound`` of the unsplit plain version, 2-D and grouped;
    ``dx_merge`` on CPU tensors is the same ordered sum."""
    G, M, K, N = shape
    g, w, m = _inputs(np.random.default_rng(19), G, M, K, N, dtype)
    if G == 1:
        g, w, m = g[0], w[0], m[0]
    want = (tmm.masked_dx_plain if G == 1 else tmm.grouped_masked_dx_plain)(g, w, m)
    wm = (w * m.to(w.dtype)).float()
    absp = g.float().abs() @ wm.abs().transpose(-1, -2)
    bound = tmm.matmul_error_bound(want, absp, N)
    for n_split in range(1, -(-N // tmm.FWD_SLAB) + 1):
        got = tmm.masked_dx_split_plain(g, w, m, n_split)
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        part = torch.stack([g.float()[..., a:b] @ wm[..., a:b].transpose(-1, -2)
                            for a, b in tmm.fwd_split_ranges(N, n_split)])
        n0 = tmm.dx_merge_launches
        merged = tmm.dx_merge(part, torch.empty(want.shape, dtype=dtype))
        assert torch.equal(merged, got) and tmm.dx_merge_launches == n0


# relative to the largest magnitude, as tests/test_torch_masked.py states:
# f32 the same products summed in another order; bf16 one ulp
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", [
    # (G, M, K, N, real rows, n_split): 4 rows padded to 16 with N off the
    # slabs (80 = 2.5 slabs); an aligned split; a grouped bank
    (1, 16, 48, 80, 4, 2), (1, 32, 64, 128, None, 4), (3, 16, 32, 96, 5, 3)])
def test_dx_split_plain_matches_the_reference_kernel(dtype, case):
    """The split plain version against the reference's Pallas dgrad
    (``_dx_call``, or ``_g_dx_call`` on a bank) in interpret mode, on the
    same numpy inputs."""
    G, M, K, N, rows, n_split = case
    g, w, m = _inputs(np.random.default_rng(23), G, M, K, N, dtype, rows)
    j = lambda t: jnp.asarray(t.float().numpy(), JDT[dtype])
    if G == 1:
        got = tmm.masked_dx_split_plain(g[0], w[0], m[0], n_split)
        want = jmm._dx_call(j(g[0]), j(w[0]), jnp.asarray(m[0].numpy()), 16, 16, 16, True,
                            JDT[dtype])
    else:
        got = tmm.masked_dx_split_plain(g, w, m, n_split)
        want = jmm._g_dx_call(j(g), j(w), jnp.asarray(m.numpy()), 16, 16, 16, True,
                              JDT[dtype])
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert got.shape == want.shape
    assert err <= TOL[dtype] * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("dtype", [F32, BF])
def test_dx_split_plain_inf_under_zero_mask_is_nan(dtype):
    """The mask multiplies, never selects: an inf weight under a zero mask
    gives NaN in the split plain version in exactly the unsplit one's
    places (dx's column of that weight's row), 2-D and grouped; a NaN
    weight under a one the same."""
    G, M, K, N = 2, 16, 32, 96
    g, w, m = _inputs(np.random.default_rng(29), G, M, K, N, dtype)
    w[0, 5, 7], m[0, 5, 7] = float("inf"), False
    w[1, 9, 70], m[1, 9, 70] = float("nan"), True
    want = torch.isnan(tmm.grouped_masked_dx_plain(g, w, m))
    assert bool(want[0, :, 5].all()) and bool(want[1, :, 9].all())
    assert int(want.sum()) == 2 * M
    for n_split in (1, 2, 3):
        got = tmm.masked_dx_split_plain(g, w, m, n_split)
        assert torch.equal(torch.isnan(got), want), n_split
        got2 = tmm.masked_dx_split_plain(g[0], w[0], m[0], n_split)
        assert torch.equal(torch.isnan(got2), torch.isnan(tmm.masked_dx_plain(g[0], w[0], m[0])))
