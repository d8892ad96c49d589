"""Port kernels vs the JAX package: block-sparse forward (K1) and flash
forward (K9).

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels build and run only on the card); the JAX side runs its Pallas
kernels in interpret mode and its jnp oracles.  Inputs are made from a seed
with numpy and handed to both.  tests/test_torch_cuda.py holds the CUDA
kernels against these plain versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.pack import pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear  # noqa: E402

BLOCK = 16
# f32: the two sides sum the same products in another order (1e-5 relative
# of |y| ~ 1).  bf16: both accumulate in f32 and round once to bf16, so an
# output may land one bf16 ulp apart, at most 2**-7 of its magnitude; the
# tolerance is one ulp at the output's largest magnitude.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _close(got_t, want_j, dtype, what):
    got = got_t.float().numpy()
    want = np.asarray(want_j, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    tol = TOL[dtype] * max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, f"{what}: max |port - jax| = {err} > {tol}"


def _block_problem(seed=0, K=64, N=80):
    rng = np.random.default_rng(seed)
    bm = rng.random((K // BLOCK, N // BLOCK)) < 0.5
    bm[:, 1] = False  # an all-empty column: the kernel must write zeros
    bm[0, 0] = True
    dense = np.repeat(np.repeat(bm, BLOCK, 0), BLOCK, 1)
    w = rng.standard_normal((K, N)).astype(np.float32) * dense / np.sqrt(K)
    return rng, bm, w


def test_pack_np_matches_reference():
    _, bm, _ = _block_problem()
    idx, cnt = pack_np(bm)
    jidx, jcnt = jbsm.pack_block_mask(bm)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_plain_matches_jax_kernel(dtype):
    rng, bm, w = _block_problem(1)
    x = rng.standard_normal((32, w.shape[0])).astype(np.float32)
    idx, cnt = pack_np(bm)
    xt, xj = _as(x, dtype)
    wt, wj = _as(w, dtype)
    got = tbsm.block_sparse_matmul(
        xt, wt, torch.from_numpy(idx), torch.from_numpy(cnt),
        bm=16, bn=BLOCK, bk=BLOCK,
    )
    want = jbsm.block_sparse_matmul(
        xj, wj, jnp.asarray(idx), jnp.asarray(cnt), bm=16, bn=BLOCK,
        bk=BLOCK, interpret=True,
    )
    _close(got, want, dtype, "kernel")
    _close(got, ref.block_sparse_matmul_ref(xj, wj, jnp.asarray(bm), BLOCK, BLOCK),
           dtype, "oracle")
    assert not got[:, BLOCK:2 * BLOCK].float().abs().any()  # empty column


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [3, 40])
def test_block_sparse_linear_matches_jax(M, dtype):
    """Row padding: M=3 shrinks the row tile to 16, M=40 pads to 48."""
    rng, bm, w = _block_problem(2)
    x = rng.standard_normal((1, M, w.shape[0])).astype(np.float32)
    idx, cnt = pack_np(bm)
    xt, xj = _as(x, dtype)
    wt, wj = _as(w, dtype)
    block = (128, BLOCK, BLOCK)
    got = block_sparse_linear(
        xt, wt, pack=(torch.from_numpy(idx), torch.from_numpy(cnt)), block=block
    )
    want = jops.block_sparse_linear(
        xj, wj, block=block, pack=(jnp.asarray(idx), jnp.asarray(cnt))
    )
    _close(got, want, dtype, f"block_sparse_linear M={M}")


FLASH_CASES = {
    # name: (Sq, Sk, causal, window, softcap, kv_groups)
    "causal": (32, 32, True, 0, 0.0, 1),
    "window": (48, 48, True, 8, 0.0, 1),
    "ragged": (40, 40, True, 0, 0.0, 1),
    "gqa": (32, 32, True, 0, 0.0, 2),
    "softcap": (32, 32, True, 0, 30.0, 1),
    "q_offset": (16, 40, True, 0, 0.0, 2),
}


@pytest.mark.parametrize("blocks", [(16, 16), (128, 128)])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_jax_kernel(case, blocks):
    Sq, Sk, causal, window, softcap, G = FLASH_CASES[case]
    BH, d = 4, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((BH, Sq, d)).astype(np.float32)
    k = rng.standard_normal((BH // G, Sk, d)).astype(np.float32)
    v = rng.standard_normal((BH // G, Sk, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, kv_groups=G,
              bq=blocks[0], bk=blocks[1], return_lse=True)
    o, lse = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    jo, jlse = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   interpret=True, **kw)
    _close(o, jo, "float32", f"{case} o")
    _close(lse, jlse, "float32", f"{case} lse")


def test_flash_bf16_matches_jax_kernel():
    """bf16 q/k/v: both round p to bf16 before p @ v, at different running
    maxima (per block vs per row), so o differs by bf16 rounding of the
    weights: 2**-7 of |v| ~ 4."""
    BH, S, d = 4, 48, 16
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((BH, S, d)) for _ in range(3))
    (qt, qj), (kt, kj), (vt, vj) = (_as(a, "bfloat16") for a in (q, k, v))
    kw = dict(causal=True, window=24, bq=16, bk=16, return_lse=True)
    o, lse = tfa.flash_attention(qt, kt, vt, **kw)
    jo, jlse = jfa.flash_attention(qj, kj, vj, interpret=True, **kw)
    assert o.dtype == torch.bfloat16
    err = float(np.max(np.abs(o.float().numpy() - np.asarray(jo, np.float32))))
    assert err <= 4 * 2.0 ** -7, err
    _close(lse, jlse, "float32", "bf16 lse")


def test_wrappers_refuse_other_devices():
    """No quiet fallback: only CPU tensors take the plain versions."""
    x = torch.empty(16, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbsm.block_sparse_matmul(x, x.T, x, x, bm=16, bn=16, bk=16)
    q = torch.empty(2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q, q, q, q, q, bq=16, bk=16, causal=True, window=0,
                      q_offset=0, sk=16, scale=0.25, softcap=0.0, kv_groups=1)


def _online_softmax(q, k, v, sched, *, bq, bk, window, G, fault=None):
    """The CUDA flash kernel's arithmetic on the CPU: per live KV block an
    f32 running max and sum, p rounded to bf16 before p @ v, the f32 output
    accumulator rescaled by exp(m_prev - m_new).  ``fault`` plants one of the
    errors the o check must see: a missed rescale, a wrong GQA row for V, or
    the wrong V block on one step."""
    BH, S, d = q.shape
    kv = torch.arange(BH) // G
    o = torch.zeros(BH, S, d)
    for qb in range(S // bq):
        rows = slice(qb * bq, (qb + 1) * bq)
        qpos = torch.arange(qb * bq, (qb + 1) * bq)[:, None]
        m = torch.full((BH, bq, 1), -1e30)
        l, acc = torch.zeros(BH, bq, 1), torch.zeros(BH, bq, d)
        for step in range(int(sched["kv_cnt"][qb])):
            kb = int(sched["kv_idx"][qb, step])
            kpos = torch.arange(kb * bk, (kb + 1) * bk)[None, :]
            s = q[:, rows].float() @ k[kv, kb * bk:(kb + 1) * bk].float().transpose(1, 2)
            ok = (kpos <= qpos) & (kpos > qpos - window)
            s = (s * d ** -0.5).masked_fill(~ok, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new).masked_fill(~ok, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            vrow = (kv + 1) % (BH // G) if fault == "gqa_row" else kv
            vb = (kb + 1) % (S // bk) if fault == "v_block" and step == 0 else kb
            pv = p.bfloat16().float() @ v[vrow, vb * bk:(vb + 1) * bk].float()
            acc = (acc if fault == "no_rescale" else acc * corr) + pv
            m = m_new
        o[:, rows] = acc / l.clamp_min(1e-30)
    return o.bfloat16()


@pytest.mark.parametrize("fault", [None, "no_rescale", "gqa_row", "v_block"])
def test_flash_o_bound_holds_and_catches_faults(fault):
    """``o_error_bound`` (the per-element o check of the CUDA kernel against
    the plain version) holds for the kernel's own arithmetic and fails for
    each planted fault."""
    from repro_torch.core.attn_sched import sched_for

    S, window, G, d, b = 512, 256, 2, 80, 64
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, S, d)).astype(np.float32))
               .to(torch.bfloat16) for n in (4, 4 // G, 4 // G))
    sched = sched_for(S, S, b, b, True, window, 0)
    args = (torch.from_numpy(sched["kv_idx"]), torch.from_numpy(sched["kv_cnt"]))
    kw = dict(bq=b, bk=b, causal=True, window=window, q_offset=0, sk=S,
              scale=d ** -0.5, softcap=0.0, kv_groups=G)
    po, _ = tfa.flash_attention_plain(q, k, v, *args, **kw)
    pa, _ = tfa.flash_attention_plain(q, k, v.abs(), *args, **kw)
    o = _online_softmax(q, k, v, sched, bq=b, bk=b, window=window, G=G, fault=fault)
    within = (o.float() - po.float()).abs() <= tfa.o_error_bound(po, pa)
    assert bool(within.all()) == (fault is None)
