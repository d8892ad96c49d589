"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (bf16 and f32), K2, K3, K9, K10 and K11, and one training step.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it runs on a machine that has
only PyTorch:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pack import pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear  # noqa: E402

FLASH_CASES = {
    # name: (Sq, Sk, causal, window, softcap, kv_groups)
    "causal": (256, 256, True, 0, 0.0, 1),
    "window": (300, 300, True, 64, 0.0, 4),
    "ragged": (100, 100, True, 0, 0.0, 4),
    "softcap": (256, 256, True, 0, 30.0, 4),
    "q_offset": (64, 200, True, 0, 0.0, 2),
    "full": (128, 128, False, 0, 0.0, 1),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


BS_SHAPES = [(4, 256, 384, 128), (200, 512, 256, 128), (16, 96, 64, 16),
             (40, 64, 160, 32)]


def _bs_problem(shape, seed=5):
    """x (M, K), w (K, N) zero outside a random block mask with an empty
    column and an empty row, g (M, N); the CSC, CSR and a superset CSC."""
    M, K, N, blk = shape
    rng = np.random.default_rng(seed)
    bm = rng.random((K // blk, N // blk)) < 0.5
    bm[:, 0] = False
    bm[-1, :] = False
    bm[0, -1] = True
    sup = bm | (rng.random(bm.shape) < 0.3)
    dense = np.repeat(np.repeat(bm, blk, 0), blk, 1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    w = f(rng.standard_normal((K, N)) * dense / np.sqrt(K))
    x, g = f(rng.standard_normal((M, K))), f(rng.standard_normal((M, N)))
    packs = [torch.from_numpy(a) for a in (*pack_np(bm), *pack_np(bm.T), *pack_np(sup))]
    return x, w, g, packs, bm, sup


def _bound_ok(got, want, abs_prod, n):
    """Per element within ``matmul_error_bound`` (both sides sum n products
    in f32 and round once to the output's dtype)."""
    bound = tbsm.matmul_error_bound(want, abs_prod, n)
    return bool(((got.float().cpu() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", BS_SHAPES)
def test_cuda_block_sparse_matches_plain(shape, dtype):
    """K1 in bf16 and f32 against its plain version, element by element
    within ``matmul_error_bound`` (bf16 also within one bf16 ulp of the
    largest output: both round once); the empty column comes out zero."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, w, _, (idx, cnt, *_), _, _ = _bs_problem(shape)
    blk = shape[3]
    args = (x.to(dt), w.to(dt))
    block = (128, blk, blk)
    got = block_sparse_linear(*(a.to(dev) for a in args),
                              pack=(idx.to(dev), cnt.to(dev)), block=block)
    want = block_sparse_linear(*args, pack=(idx, cnt), block=block)
    absp = block_sparse_linear(*(a.abs().float() for a in args), pack=(idx, cnt),
                               block=block)
    assert not got[:, :blk].float().abs().any()  # the empty column
    assert _bound_ok(got, want, absp, shape[1])
    if dt == torch.bfloat16:  # and within one bf16 ulp of the largest output
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", BS_SHAPES)
def test_cuda_block_sparse_backward_matches_plain(shape, dtype):
    """K2 (dx on the CSR) and K3 (dw on the superset CSC) against their
    plain versions, element by element within ``matmul_error_bound``; the
    empty K-block row's dx tile is zero and dw lives on the superset only."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    M, K, N, blk = shape
    x, w, g, (_, _, ridx, rcnt, bidx, bcnt), _, sup = _bs_problem(shape)
    Mp = -(-M // 16) * 16
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Mp - M)).to(dt)
    x, g, w = pad(x), pad(g), w.to(dt)
    bm_rows = min(128, Mp) if Mp % min(128, Mp) == 0 else 16
    on = lambda *ts: [t.to(dev) for t in ts]
    dx = tbsm.block_sparse_dx(*on(g, w, ridx, rcnt), bm=bm_rows, bn=blk, bk=blk)
    dx_want = tbsm.block_sparse_dx(g, w, ridx, rcnt, bm=bm_rows, bn=blk, bk=blk)
    dx_abs = tbsm.block_sparse_dx_plain(g.abs().float(), w.abs().float(), ridx, rcnt, blk, blk)
    assert _bound_ok(dx, dx_want, dx_abs, N)
    assert not dx[:, -blk:].float().any()
    dw = tbsm.block_sparse_dw(*on(x, g, bidx, bcnt), bn=blk, bk=blk)
    dw_want = tbsm.block_sparse_dw(x, g, bidx, bcnt, bn=blk, bk=blk)
    dw_abs = tbsm.block_sparse_dw_plain(x.abs().float(), g.abs().float(), bidx, bcnt, blk, blk)
    assert _bound_ok(dw, dw_want, dw_abs, Mp)
    support = np.repeat(np.repeat(sup, blk, 0), blk, 1)
    assert not dw.float().cpu().numpy()[~support].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_matches_plain(case):
    dev = _cuda()
    Sq, Sk, causal, window, softcap, G = FLASH_CASES[case]
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, 80)).astype(np.float32))
               .to(torch.bfloat16) for n, s in ((8, Sq), (8 // G, Sk), (8 // G, Sk)))
    # o, element by element: the bound of rounding p to bf16 in the kernel
    # and o to bf16 on both sides (tfa.o_error_bound); lse: f32 in both
    kw = dict(causal=causal, window=window, softcap=softcap, kv_groups=G,
              return_lse=True)
    o, lse = tfa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    po, plse = tfa.flash_attention(q, k, v, **kw)
    pa, _ = tfa.flash_attention(q, k, v.abs(), **kw)
    assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse.cpu() - plse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_backward_matches_plain(case):
    """K10 (dq) and K11 (dk, dv) against their plain versions, element by
    element within ``grad_error_bound``."""
    dev = _cuda()
    Sq, Sk, causal, window, softcap, G = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, 80)).astype(np.float32))
               .to(torch.bfloat16) for n, s in ((8, Sq), (8 // G, Sk), (8 // G, Sk)))
    do = torch.from_numpy(rng.standard_normal((8, Sq, 80)).astype(np.float32)).to(torch.bfloat16)
    bq, bk = tfa.effective_blocks(Sq, Sk)
    Sqp, Skp = -(-Sq // bq) * bq, -(-Sk // bk) * bk
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))
    q, do, k, v = pad(q, Sqp), pad(do, Sqp), pad(k, Skp), pad(v, Skp)
    sched = tfa._schedule_on(torch.device("cpu"), Sq, Sk, bq, bk, causal, window, Sk - Sq)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=Sk - Sq, sk=Sk,
              scale=80 ** -0.5, softcap=softcap, kv_groups=G)
    o, lse = tfa.flash_fwd(q, k, v, sched[0], sched[1], **kw)
    delta = (do.float() * o.float()).sum(-1)
    blocks = tfa._schedule_mask(sched[0], sched[1], Skp // bk, "cpu")
    *want, dq_a, dk_a, dv_a, dq_e, dk_e, dv_e = tfa.flash_bwd_plain(
        q, k, v, do, lse, delta, blocks, with_abs=True, **kw)
    on = lambda *ts: [t.to(dev) for t in ts]
    dq = tfa.flash_dq(*on(q, k, v, do, lse, delta, sched[0], sched[1]), **kw)
    dk, dv = tfa.flash_dkv(*on(q, k, v, do, lse, delta, sched[2], sched[3]), **kw)
    for name, got, w_, a, e in (("dq", dq, want[0], dq_a, dq_e),
                                ("dk", dk, want[1], dk_a, dk_e),
                                ("dv", dv, want[2], dv_a, dv_e)):
        diff = (got.float().cpu() - w_.float()).abs()
        assert bool((diff <= tfa.grad_error_bound(w_, a, e)).all()), name


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor a kernel does not take raises; nothing falls back to
    the plain version."""
    dev = _cuda()
    x = torch.zeros(16, 128, device=dev, dtype=torch.float16)
    w = torch.zeros(128, 128, device=dev, dtype=torch.float16)
    idx = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    cnt = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        block_sparse_linear(x, w, pack=(idx, cnt))
    with pytest.raises(TypeError, match="bf16 or f32"):
        tbsm.block_sparse_dx(x, w, idx, cnt, bm=16, bn=128, bk=128)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tbsm.block_sparse_dw(x, x, idx, cnt, bn=128, bk=128)
    with pytest.raises(TypeError, match="bf16 or f32"):  # mixed dtypes
        tbsm.block_sparse_dw(x.float(), x.bfloat16(), idx, cnt, bn=128, bk=128)
    q = torch.zeros(2, 32, 80, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_attention(q, q, q)
    qb = q.bfloat16()
    stats = torch.zeros(2, 32, device=dev)
    sched = tfa._schedule_on(dev, 32, 32, 32, 32, True, 0, 0)
    kw = dict(bq=32, bk=32, causal=True, window=0, q_offset=0, sk=32, scale=0.1,
              softcap=0.0, kv_groups=1)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_dq(qb, qb, qb, q, stats, stats, sched[0], sched[1], **kw)
    with pytest.raises(TypeError, match="f32"):
        tfa.flash_dkv(qb, qb, qb, qb, stats.double(), stats, sched[2], sched[3], **kw)


@pytest.mark.cuda
def test_cuda_training_step_runs_the_kernels():
    """A danube SMOKE train step (block 16, flash_tight, bf16 attention and
    f32 MLP) on the card launches K1, K2, K3, K9, K10 and K11 and agrees
    with the same step on the CPU (plain versions) within bf16 tolerance."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps

    dev = _cuda()
    cfg = dataclasses.replace(
        get_config("h2o-danube-1.8b", smoke=True),
        sparse=SparseConfig(sparsity=0.8, kernel="block_sparse", block_shape=(16, 16),
                            kernel_block=(128, 16, 16), attn_kernel="flash_tight"))
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr = LRSchedule(kind="constant", base_lr=1e-3, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 32)))
    batch = {"tokens": toks, "targets": (toks * 3 + 7) % 128}
    losses = []
    for device in ("cpu", dev):
        st, _ = steps.init_train_state(cfg, opt, seed=0, device="cpu")
        st = {k: _to(v, device) for k, v in st.items()}
        counts = [bsm.launches, bsm.dx_launches, bsm.dw_launches, tfa.launches,
                  tfa.dq_launches, tfa.dkv_launches]
        st, m = steps.make_train_step(cfg, opt, lr)(
            st, {k: v.to(device) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        after = [bsm.launches, bsm.dx_launches, bsm.dw_launches, tfa.launches,
                 tfa.dq_launches, tfa.dkv_launches]
    assert all(b > a for a, b in zip(counts, after))
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[0])


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree
