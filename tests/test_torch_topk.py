"""The port's k-th-magnitude threshold against the JAX package's: the plain
version of K21's histogram (the kernel's CPU counterpart) equal, bin for
bin, to the reference kernel in interpret mode and to its oracle
``histogram_abs_ref``; ``ops.topk_threshold`` bit for bit with and without
the refinement pass; the refinement's behaviour pinned as the reference
has it; a NaN's bin.  Inputs are made from seeds and handed to both
packages as numpy arrays (bf16 through the bridge, bit for bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ops import topk_threshold as j_topk_threshold  # noqa: E402
from repro.kernels.topk_threshold import histogram_abs as j_histogram_abs  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import topk_threshold as tk  # noqa: E402
from repro_torch.kernels.ops import topk_threshold  # noqa: E402

# n = 200_000 and (3, 777) are not multiples of the reference's 65536 tile
SHAPES = [(1000,), (65536,), (100_000,), (200_000,), (3, 777)]


def _inputs(shape, dtype, seed=0):
    """(jax array, torch tensor) holding the same values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    return jx, bridge._tensor(np.asarray(jx))


def _bits(v):
    return np.asarray(v, np.float32).reshape(()).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_histogram_matches_reference(shape, dtype):
    """Every bin exactly equal, with the limit above max|x| (the threshold's
    first pass) and inside the range (elements clipped into bin 511)."""
    jx, tx = _inputs(shape, dtype, seed=len(shape) + shape[-1])
    top = float(jnp.max(jnp.abs(jx)).astype(jnp.float32))
    for hi in (np.float32(top) + np.float32(1e-12), np.float32(0.5 * top)):
        got = tk.histogram_abs_plain(tx, float(hi)).numpy()
        assert got.shape == (1, tk.N_BINS) and got.dtype == np.float32
        want = np.asarray(j_histogram_abs(jx, hi, interpret=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(ref.histogram_abs_ref(jx, hi)))
        assert got.sum() == np.prod(shape)
        # on a CPU tensor the wrapper is the plain version: no launch
        before = tk.launches
        np.testing.assert_array_equal(tk.histogram_abs(tx, float(hi)).numpy(), got)
        assert tk.launches == before


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("n,k", [(65536, 1000), (100_000, 5000), (200_000, 100),
                                 (50_000, 10_000)])
def test_topk_threshold_bit_for_bit(n, k, refine):
    """The reference test's (n, k) pairs on its own input (a standard
    normal from PRNGKey(0); the last pair is its rigl-drop test's size),
    the threshold bit for bit, and the kth value as the reference's."""
    jx = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)
    tx = torch.from_numpy(np.array(jx))
    want = j_topk_threshold(jx, k, refine=refine, interpret=True)
    got = topk_threshold(tx, k, refine=refine)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _bits(got) == _bits(want), (float(got), float(want))
    assert _bits(tk.kth_value_plain(tx, k)) == _bits(ref.kth_value_ref(jx, k))


def test_topk_threshold_bf16_bit_for_bit():
    jx, tx = _inputs((257, 389), "bfloat16", seed=3)
    for k in (1, 20_000, 99_973):
        for refine in (True, False):
            want = j_topk_threshold(jx, k, refine=refine, interpret=True)
            assert _bits(topk_threshold(tx, k, refine=refine)) == _bits(want), (k, refine)


def test_refinement_counts_every_outside_element_in_the_top_bin():
    """The reference's refinement replaces every element outside the
    bracketing bin by 2 * hi, so the second histogram's bin 511 holds all
    of them and the refined threshold keeps exactly the elements above the
    bracketing bin: on the reference test's first case 21 elements lie in
    the bracket, bin 511 holds the other 65515, and the threshold keeps
    994 of the k = 1000 asked for."""
    n, k = 65536, 1000
    tx = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (n,))))
    calls = []

    def recording(x, hi):
        h = tk.histogram_abs_plain(x, hi)
        calls.append((x, hi, h))
        return h

    t = topk_threshold(tx, k, histogram=recording)
    assert len(calls) == 2
    lo_edge = topk_threshold(tx, k, refine=False)
    a = tx.abs()
    upper = lo_edge + calls[0][1] / tk.N_BINS
    in_bracket = int(((a >= lo_edge) & (a < upper)).sum())
    hist2 = calls[1][2][0]
    assert in_bracket == 21 and int(hist2[511]) == n - in_bracket == 65515
    assert int(hist2[:511].sum()) == in_bracket
    in_above = int((a >= upper).sum())
    assert int((a >= t).sum()) == in_above == 994


def test_nan_goes_to_bin_zero_as_in_the_reference():
    """A NaN |x| / hi lands in bin 0, as the reference kernel's CPU run puts
    it (XLA converts NaN to int32 0; the CUDA kernel's fmaxf gives 0); inf
    in bin 511.  A NaN in x makes hi NaN, and the threshold NaN, as the
    reference's."""
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x[3], x[10], x[11] = np.nan, np.inf, -np.inf
    want = np.asarray(j_histogram_abs(jnp.asarray(x), np.float32(3.0), interpret=True))
    got = tk.histogram_abs_plain(torch.from_numpy(x), 3.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 1000
    nan_hi = tk.histogram_abs_plain(torch.from_numpy(x), float("nan")).numpy()
    np.testing.assert_array_equal(
        nan_hi, np.asarray(j_histogram_abs(jnp.asarray(x), jnp.float32(jnp.nan),
                                           interpret=True)))
    assert nan_hi[0, 0] == 1000
    for refine in (True, False):
        assert np.isnan(float(topk_threshold(torch.from_numpy(x), 100, refine=refine)))
        assert np.isnan(float(j_topk_threshold(jnp.asarray(x), 100, refine=refine,
                                               interpret=True)))
