"""K13/K16's launch plan and its split, on the CPU: the properties of
``fwd_plan`` at the paths' shapes (given as numbers), the plain version
that follows a split (``masked_matmul_split_plain``: f32 partials over
whole K slabs, summed in split order, rounded once) against the unsplit
plain version within ``matmul_error_bound``, and against the reference's
Pallas forward (``_fwd_call``, ``_g_fwd_call``) in interpret mode.

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
# CTAs resident per SM of each tile (the H100 build's occupancy; the
# wrapper reads it from the runtime)
CTAS = {(BF, 16): 6, (F32, 16): 4, (BF, 128): 2, (F32, 128): 1}
# decode shapes (16 padded rows): (K, N, dtype) of danube-1.8b's,
# mistral-large's and qwen2-moe's 2-D projections (attention bf16, MLP f32)
DECODE = {
    "danube": [(2560, 2560, BF), (2560, 640, BF), (2560, 6912, F32), (6912, 2560, F32)],
    "mistral": [(12288, 12288, BF), (12288, 1024, BF), (12288, 28672, F32),
                (28672, 12288, F32)],
    "qwen2-moe": [(2048, 2048, BF), (2048, 5632, F32), (5632, 2048, F32)],
}
# qwen2-moe's 60-expert banks (K, N) at decode (16), prefill (96) and
# training (256) rows
BANKS = [(2048, 1408), (1408, 2048)]


def _slots(dtype, Mp):
    return SMS * CTAS[(dtype, tmm.fwd_tile(Mp)[0])]


def _ctas(Mp, N, G, plan):
    bm, bn, n_split = plan
    return -(-Mp // bm) * -(-N // bn) * G * n_split


@pytest.mark.parametrize("K", [16, 48, 80, 2560, 6912])
def test_split_ranges_cover_k_in_whole_slabs(K):
    """Every split count a plan can take walks K once, in order, each split
    a run of whole 32-element slabs (the last ending at K); the plans'
    splits walk at least FWD_MIN_SLABS slabs."""
    n = -(-K // tmm.FWD_SLAB)
    for n_split in range(1, n + 1):
        r = tmm.fwd_split_ranges(K, n_split)
        assert r[0][0] == 0 and r[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(k0 % tmm.FWD_SLAB == 0 and k0 < k1 for k0, k1 in r)
    for dt in (BF, F32):
        for Mp in (16, 2048):
            bm, bn, n_split = tmm.fwd_plan(Mp, K, 2560, 1, dt, _slots(dt, Mp))
            assert n_split == 1 or n // n_split >= tmm.FWD_MIN_SLABS


@pytest.mark.parametrize("arch", sorted(DECODE))
def test_plan_fills_the_slots_at_decode(arch):
    """At 16 padded rows every SM gets a CTA and none waits for a second
    wave; the split keeps the f32 partials within a quarter of the weight
    and mask bytes."""
    for K, N, dt in DECODE[arch]:
        plan = tmm.fwd_plan(16, K, N, 1, dt, _slots(dt, 16))
        ctas = _ctas(16, N, 1, plan)
        assert plan[:2] == (16, 64) and SMS <= ctas <= _slots(dt, 16), (K, N, plan)
        es = 2 if dt == BF else 4
        assert 8 * plan[2] * 16 * N <= K * N * (es + 1) / 4 or plan[2] == 1, (K, N, plan)


@pytest.mark.parametrize("dt", [BF, F32])
def test_plan_keeps_the_banks_and_full_waves_whole(dt):
    """K16's banks (60 experts: 660-1320 CTAs) never split, at decode,
    prefill or training rows; at danube's 2048 training rows only the f32
    MLP's wo (320 CTAs on 132 slots: its third wave 42% full) and the bf16
    attention (one partial wave) split, in two."""
    for K, N in BANKS:
        for Mp in (16, 96, 256):
            assert tmm.fwd_plan(Mp, K, N, 60, dt, _slots(dt, Mp))[2] == 1, (K, N, Mp)
    want = ({(2560, 2560): 2, (2560, 640): 2} if dt == BF
            else {(2560, 6912): 1, (6912, 2560): 2})
    for (K, N), n_split in want.items():
        assert tmm.fwd_plan(2048, K, N, 1, dt, _slots(dt, 2048)) == (128, 128, n_split)
    for Mp in (16, 2048):
        cands = tmm.fwd_candidates(Mp, 2560, 2560, 1, dt, _slots(dt, Mp))
        assert tmm.fwd_plan(Mp, 2560, 2560, 1, dt, _slots(dt, Mp)) in cands
        assert all((bm, bn) in tmm.FWD_TILES for bm, bn, _ in cands)
    # a caller's column tile below 128 caps the tile at 64
    assert tmm.fwd_plan(2048, 256, 64, 1, dt, _slots(dt, 2048), bn_limit=16)[:2] == (128, 64)


def _inputs(rng, G, M, K, N, dtype, rows=None):
    """x (G, M, K) (rows past ``rows`` zero: the wrapper's padding), w, and
    a mask with an empty row and column, as numpy f32 rounded to dtype."""
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    if rows is not None:
        x[:, rows:] = 0.0
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    m = rng.random((G, K, N)) < 0.3
    m[:, 1, :] = False
    m[:, :, 2] = False
    t = lambda a: torch.from_numpy(a).to(dtype)
    return t(x), t(w), torch.from_numpy(m)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("shape", [(1, 16, 80, 48), (1, 32, 256, 64), (3, 16, 144, 32)])
def test_split_plain_matches_the_plain_version(dtype, shape):
    """Every split count (1 to every slab its own split) within
    ``matmul_error_bound`` of the unsplit plain version, 2-D and grouped;
    ``fwd_merge`` on CPU tensors is the same ordered sum."""
    G, M, K, N = shape
    x, w, m = _inputs(np.random.default_rng(11), G, M, K, N, dtype)
    if G == 1:
        x, w, m = x[0], w[0], m[0]
    want = (tmm.masked_matmul_plain if G == 1 else tmm.grouped_masked_matmul_plain)(x, w, m)
    absp = x.float().abs() @ (w.float() * m).abs()
    bound = tmm.matmul_error_bound(want, absp, K)
    for n_split in range(1, -(-K // tmm.FWD_SLAB) + 1):
        got = tmm.masked_matmul_split_plain(x, w, m, n_split)
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        wm = (w * m.to(w.dtype)).float()
        part = torch.stack([x.float()[..., a:b] @ wm[..., a:b, :]
                            for a, b in tmm.fwd_split_ranges(K, n_split)])
        merged = tmm.fwd_merge(part, torch.empty(want.shape, dtype=dtype))
        assert torch.equal(merged, got)


# relative to the largest magnitude, as tests/test_torch_masked.py states:
# f32 the same products summed in another order; bf16 one ulp
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", [
    # (G, M, K, N, real rows, n_split): 4 decode rows padded to 16 with K
    # off the slabs (80 = 2.5 slabs); an aligned split; a grouped bank
    (1, 16, 80, 48, 4, 2), (1, 32, 128, 64, None, 4), (3, 16, 96, 32, 5, 3)])
def test_split_plain_matches_the_reference_kernel(dtype, case):
    """The split plain version against the reference's Pallas forward
    (``_fwd_call``, or ``_g_fwd_call`` on a bank) in interpret mode, on the
    same numpy inputs."""
    G, M, K, N, rows, n_split = case
    x, w, m = _inputs(np.random.default_rng(13), G, M, K, N, dtype, rows)
    j = lambda t: jnp.asarray(t.float().numpy(), JDT[dtype])
    if G == 1:
        got = tmm.masked_matmul_split_plain(x[0], w[0], m[0], n_split)
        want = jmm._fwd_call(j(x[0]), j(w[0]), jnp.asarray(m[0].numpy()), 16, 16, 16, True)
    else:
        got = tmm.masked_matmul_split_plain(x, w, m, n_split)
        want = jmm._g_fwd_call(j(x), j(w), jnp.asarray(m.numpy()), 16, 16, 16, True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert got.shape == want.shape
    assert err <= TOL[dtype] * max(1.0, float(np.max(np.abs(want)))), err
