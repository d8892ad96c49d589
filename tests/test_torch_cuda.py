"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (bf16 and f32), K2, K3, the grouped K4, K5, K6, K9, K10, K11, the
paged-prefix K12, the masked K13, K14, K15, the grouped masked K16, K17,
K18 and the block-sparse wgrad K3/K6, forward K1/K4 and dgrad K2/K5 on the
GEMM core (each under every plan its sweep forces, with the split merge), the
fused epilogues K19/K20 and K7/K8 (likewise, with their fused merges), the
|x| histogram K21, the grouped kernels at xLSTM's recurrent bank's shapes,
the flash wrapper at the frontend families' shapes (hubert-xlarge's
bidirectional d = 80, internvl2-1b's G = 7 at d = 64),
training steps, paged serving, MoE serving, MoE and xLSTM training through
them; checkpoints of card tensors (the round trip and the
async snapshot) and the engine's quarantine of injected faults.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it runs on a machine that has
only PyTorch:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pack import pack_group_mask, pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear, masked_linear  # noqa: E402

FLASH_CASES = {
    # name: (Sq, Sk, causal, window, softcap, kv_groups, head_dim)
    "causal": (256, 256, True, 0, 0.0, 1, 80),
    "window": (300, 300, True, 64, 0.0, 4, 80),
    "ragged": (100, 100, True, 0, 0.0, 4, 80),
    "softcap": (256, 256, True, 0, 30.0, 4, 80),
    "q_offset": (64, 200, True, 0, 0.0, 2, 80),
    "full": (128, 128, False, 0, 0.0, 1, 80),
    # qwen2-moe's attention (G = 1, head_dim 128) at a 1000-token prefill
    "d128 G=1 S=1000": (1000, 1000, True, 0, 0.0, 1, 128),
    # ragged Sq < Sk: q_offset 223, neither length a multiple of a tile
    "ragged q_offset": (77, 300, True, 0, 0.0, 4, 80),
    # window edges inside the 64-key tiles and the 128-row q-blocks
    "window edge": (400, 400, True, 100, 0.0, 4, 80),
    "window edge d128": (520, 520, True, 200, 0.0, 2, 128),
    # gemma3's head_dim 256 (exact instantiations): the softcap and a
    # ragged Sq < Sk
    "softcap d256": (256, 256, True, 0, 30.0, 2, 256),
    "ragged q_offset d256": (77, 300, True, 0, 0.0, 2, 256),
    # grok-1-314b's attention: softcap 30 at head_dim 128, G = 6
    "softcap d128 G=6": (256, 256, True, 0, 30.0, 6, 128),
    "softcap d128 G=6 ragged": (300, 300, True, 0, 30.0, 6, 128),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (M, K, N, block); the last two hymba-1.5b's wk at a 200-token prompt and
# out_proj at a decode step's 16 rows, in its 64 x 64 blocks
BS_SHAPES = [(4, 256, 384, 128), (200, 512, 256, 128), (16, 96, 64, 16),
             (40, 64, 160, 32),
             (200, 1600, 320, 64), (16, 3200, 1600, 64)]


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
    Sq, Sk, causal, window, softcap, G, d = FLASH_CASES[case]
    rng = np.random.default_rng(6)
    nq = G * max(1, 8 // G)  # 8 query heads, or one group when G does not divide 8
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, d)).astype(np.float32))
               .to(torch.bfloat16) for n, s in ((nq, Sq), (nq // G, Sk), (nq // G, Sk)))
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
    Sq, Sk, causal, window, softcap, G, d = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    nq = G * max(1, 8 // G)  # 8 query heads, or one group when G does not divide 8
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, d)).astype(np.float32))
               .to(torch.bfloat16) for n, s in ((nq, Sq), (nq // G, Sk), (nq // G, Sk)))
    do = torch.from_numpy(rng.standard_normal((nq, Sq, d)).astype(np.float32)).to(torch.bfloat16)
    bq, bk = tfa.effective_blocks(Sq, Sk)
    Sqp, Skp = -(-Sq // bq) * bq, -(-Sk // bk) * bk
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))
    q, do, k, v = pad(q, Sqp), pad(do, Sqp), pad(k, Skp), pad(v, Skp)
    sched = tfa._schedule_on(torch.device("cpu"), Sq, Sk, bq, bk, causal, window, Sk - Sq)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=Sk - Sq, sk=Sk,
              scale=d ** -0.5, softcap=softcap, kv_groups=G)
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


# (M, K, N, bm, bn, bk): decode rows padded to 16, a 128-tile case, small
# 16/32 tiles; K and N multiples of 16, M of the row tile
MASKED_SHAPES = [(16, 256, 384, 16, 128, 128), (256, 512, 256, 128, 128, 128),
                 (48, 96, 64, 16, 16, 16), (64, 64, 160, 32, 32, 32)]


def _assert_within(got, want, abs_prod, n):
    """Element by element within ``matmul_error_bound``, on the card."""
    bound = tmm.matmul_error_bound(want, abs_prod, n)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float((diff / bound.clamp_min(1e-30)).max())


def _masked_problem(shape, dtype, dev, seed=7):
    """x, w, g in ``dtype``, an elementwise mask with an empty row and an
    empty column, a superset of it, on ``dev``."""
    M, K, N = shape[:3]
    rng = np.random.default_rng(seed)
    m = rng.random((K, N)) < 0.2
    m[3, :] = False
    m[:, 5] = False
    b = m | (rng.random((K, N)) < 0.1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (f(rng.standard_normal((M, K))), f(rng.standard_normal((K, N)) / np.sqrt(K)),
            f(rng.standard_normal((M, N))), t(m), t(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MASKED_SHAPES)
def test_cuda_masked_matches_plain(shape, dtype):
    """K13 forward, K14 dx and K15 dw (on the superset) element by element
    within ``matmul_error_bound`` of their plain versions on the same card;
    exact zeros off the wgrad mask; the launch counters move."""
    dev = _cuda()
    M, K, N, bm, bn, bk = shape
    x, w, g, m, b = _masked_problem(shape, dtype, dev)
    n = [tmm.launches, tmm.dx_launches, tmm.dw_launches]
    y = tmm.masked_matmul(x, w, m, bm=bm, bn=bn)
    dx = tmm.masked_dx(g, w, m, bm=bm, bk=bk)
    dw = tmm.masked_dw(x, g, b, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert [tmm.launches, tmm.dx_launches, tmm.dw_launches] == [c + 1 for c in n]
    wm = (w * m).float().abs()
    _assert_within(y, tmm.masked_matmul_plain(x, w, m), x.float().abs() @ wm, K)
    _assert_within(dx, tmm.masked_dx_plain(g, w, m), g.float().abs() @ wm.T, N)
    _assert_within(dw, tmm.masked_dw_plain(x, g, b),
                   (x.float().abs().T @ g.float().abs()) * b, M)
    assert y.dtype == dx.dtype == dw.dtype == dtype
    assert not dw[~b].any()


@pytest.mark.cuda
@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.bfloat16),
                                   (torch.float32, torch.float32),
                                   (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", MASKED_SHAPES[1:3])
def test_cuda_fused_dw_matches_plain(shape, types):
    """K19 without sr within ``fused_error_bound`` of its plain version;
    with sr bit for bit the plain ``sr_to_bf16`` of the kernel's own f32
    m_new (the f32-output entry, sr off), on the bf16 grid, zero off the
    wgrad mask; a seed with the sign bit set."""
    dev = _cuda()
    wdt, mdt = types
    M, K, N, bm, bn, bk = shape
    x, w, g, _, b = _masked_problem(shape, wdt, dev)
    mom = (torch.randn(K, N, device=dev) * 0.1).to(mdt)
    kw = dict(mu=0.9, wd=1e-4, bn=bn, bk=bk)
    seed = 0x9E3779B9
    got = tmm.masked_dw_fused(x, g, b, w, mom, seed, sr=False, **kw)
    want = tmm.masked_dw_fused_plain(x, g, b, w, mom, seed, mu=0.9, wd=1e-4, sr=False)
    acc = x.float().T @ g.float()
    absp = x.float().abs().T @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, w, acc, b)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float((diff / bound.clamp_min(1e-30)).max())
    raw = tmm.masked_dw_fused(x, g, b, w, mom, seed, sr=False, out_dtype=torch.float32, **kw)
    sr = tmm.masked_dw_fused(x, g, b, w, mom, seed, sr=True, **kw)
    want_sr = tmm.sr_to_bf16(raw, seed, tmm._gid(K, N, dev)).to(wdt)
    torch.cuda.synchronize()
    assert torch.equal(sr.view(torch.int16 if wdt == torch.bfloat16 else torch.int32),
                       want_sr.view(torch.int16 if wdt == torch.bfloat16 else torch.int32))
    assert torch.equal(sr.float(), sr.to(torch.bfloat16).float())
    assert not sr[~b].any() and not got[~b].any()


# (G, M, K, N): decode rows (16) with K off the 32-element slabs; an
# aligned shape; a grouped bank at decode rows; a grouped bank at 96 rows
FWD_SHAPES = [(1, 16, 656, 384), (1, 256, 512, 384), (4, 16, 272, 192), (3, 96, 384, 256)]


def _fwd_plans(G, M, K, N, dtype):
    """Every plan the sweeps force at this shape (``fwd_candidates`` on the
    card's slots) and every built tile unsplit and split in 3."""
    bm, bn = tmm.fwd_tile(M)
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tmm.fwd_launch_info(dtype, bm, bn)["ctas_per_sm"])
    plans = set(tmm.fwd_candidates(M, K, N, G, dtype, slots))
    plans |= {(tbm, tbn, n) for tbm, tbn in tmm.FWD_TILES for n in (1, 3)}
    return sorted(plans)


def _fwd(x, w, m, plan):
    if x.dim() == 3:
        return tmm.grouped_masked_matmul(x, w, m, bm=16, bn=16, plan=plan)
    return tmm.masked_matmul(x, w, m, bm=16, bn=16, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_cuda_masked_fwd_every_plan_matches_plain(shape, dtype):
    """K13 (G = 1) and K16 under every forced plan (tile, split) element by
    element within ``matmul_error_bound`` of the plain version; a split
    counts one K13/K16 launch and one merge; two launches of one plan give
    the same bits."""
    dev = _cuda()
    G, M, K, N = shape
    rng = np.random.default_rng(17)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = f(rng.standard_normal((G, M, K)))
    w = f(rng.standard_normal((G, K, N)) / np.sqrt(K))
    mk = rng.random((G, K, N)) < 0.2
    mk[:, 3, :] = False
    mk[:, :, 5] = False
    m = torch.from_numpy(mk).to(dev)
    if G == 1:
        x, w, m = x[0], w[0], m[0]
    want = (tmm.masked_matmul_plain if G == 1 else tmm.grouped_masked_matmul_plain)(x, w, m)
    absp = x.float().abs() @ (w.float() * m).abs()
    for plan in _fwd_plans(G, M, K, N, dtype):
        n = [tmm.launches, tmm.g_launches, tmm.fwd_merge_launches]
        got = _fwd(x, w, m, plan)
        again = _fwd(x, w, m, plan)
        torch.cuda.synchronize()
        k = 2 if plan[2] > 1 else 0
        assert [tmm.launches, tmm.g_launches, tmm.fwd_merge_launches] == (
            [n[0] + 2, n[1], n[2] + k] if G == 1 else [n[0], n[1] + 2, n[2] + k]), plan
        assert got.dtype == dtype and got.shape == want.shape
        _assert_within(got, want, absp, K)
        iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(iv), again.view(iv)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_masked_fwd_inf_under_zero_mask_is_nan(dtype):
    """The mask multiplies (never selects): an inf weight under a zero mask
    gives NaN in exactly the plain version's places, through K13 and K16,
    split and unsplit; a NaN weight under a one the same."""
    dev = _cuda()
    x, w, _, m, _ = _masked_problem((16, 256, 128), dtype, dev)
    w[5, 7], m[5, 7] = float("inf"), False
    w[9, 30], m[9, 30] = float("nan"), True
    want = torch.isnan(tmm.masked_matmul_plain(x, w, m))
    assert bool(want[:, 7].all()) and bool(want[:, 30].all())
    for plan in ((16, 64, 1), (16, 64, 4), (128, 128, 1), (128, 128, 2)):
        assert torch.equal(torch.isnan(tmm.masked_matmul(x, w, m, bm=16, bn=128, plan=plan)),
                           want), plan
        got = tmm.grouped_masked_matmul(x[None], w[None], m[None], bm=16, bn=128, plan=plan)
        assert torch.equal(torch.isnan(got[0]), want), plan


@pytest.mark.cuda
def test_cuda_masked_fwd_has_no_spill():
    """No instantiation of the forward spills a register (the build's
    ``-Xptxas=-v``, read back from the runtime), and each holds at least
    one CTA an SM."""
    _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        for bm, bn in tmm.FWD_TILES:
            info = tmm.fwd_launch_info(dtype, bm, bn)
            assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1, (dtype, bm, bn, info)


@pytest.mark.cuda
def test_cuda_masked_fwd_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits: at 2048 rows (danube's wi, 2560 -> 6912,
    density 0.165) the kernel's RMS error against a float64 product is at
    most 8x the plain f32 product's (one-pass TF32 would be ~1000x)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(2048, 2560, device=dev, generator=gen)
    w = torch.randn(2560, 6912, device=dev, generator=gen) / 2560 ** 0.5
    m = torch.rand(2560, 6912, device=dev, generator=gen) < 0.165
    ref = x.double() @ (w * m).double()
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    got = rms(tmm.masked_matmul(x, w, m, bm=128, bn=128))
    assert got <= 8 * rms(tmm.masked_matmul_plain(x, w, m)), got


# (G, M, K, N) of the dgrad g (G, M, N) @ (w * m)^T, w (G, K, N): decode
# rows (16) with N off the 32-element slabs; an aligned shape; a grouped
# bank at 16 rows with K off the 64-column tile; a grouped bank at 96 rows
DX_SHAPES = [(1, 16, 384, 656), (1, 256, 384, 512), (4, 16, 208, 272), (3, 96, 256, 384)]


def _dx_plans(G, M, K, N, dtype):
    """Every plan the sweeps force at this dgrad shape (``fwd_candidates``
    on rows M, contraction N, columns K and the dgrad kernel's slots) and
    every built tile unsplit and split in 3."""
    bm, bn = tmm.fwd_tile(M)
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tmm.fwd_launch_info(dtype, bm, bn, "dx")["ctas_per_sm"])
    plans = set(tmm.fwd_candidates(M, N, K, G, dtype, slots))
    plans |= {(tbm, tbn, n) for tbm, tbn in tmm.FWD_TILES for n in (1, 3)}
    return sorted(plans)


def _dx(g, w, m, plan):
    if g.dim() == 3:
        return tmm.grouped_masked_dx(g, w, m, bm=16, bk=16, plan=plan)
    return tmm.masked_dx(g, w, m, bm=16, bk=16, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DX_SHAPES)
def test_cuda_masked_dx_every_plan_matches_plain(shape, dtype):
    """K14 (G = 1) and K17 under every forced plan (tile, split) element by
    element within ``matmul_error_bound`` of the plain version; a split
    counts one K14/K17 launch and one dx merge (and no forward merge); two
    launches of one plan give the same bits."""
    dev = _cuda()
    G, M, K, N = shape
    rng = np.random.default_rng(31)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    g = f(rng.standard_normal((G, M, N)))
    w = f(rng.standard_normal((G, K, N)) / np.sqrt(N))
    mk = rng.random((G, K, N)) < 0.2
    mk[:, 3, :] = False
    mk[:, :, 5] = False
    m = torch.from_numpy(mk).to(dev)
    if G == 1:
        g, w, m = g[0], w[0], m[0]
    want = (tmm.masked_dx_plain if G == 1 else tmm.grouped_masked_dx_plain)(g, w, m)
    absp = g.float().abs() @ (w.float() * m).abs().transpose(-1, -2)
    for plan in _dx_plans(G, M, K, N, dtype):
        n = [tmm.dx_launches, tmm.gdx_launches, tmm.dx_merge_launches, tmm.fwd_merge_launches]
        got = _dx(g, w, m, plan)
        again = _dx(g, w, m, plan)
        torch.cuda.synchronize()
        k = 2 if plan[2] > 1 else 0
        assert [tmm.dx_launches, tmm.gdx_launches, tmm.dx_merge_launches,
                tmm.fwd_merge_launches] == (
            [n[0] + 2, n[1], n[2] + k, n[3]] if G == 1 else [n[0], n[1] + 2, n[2] + k, n[3]]), plan
        assert got.dtype == dtype and got.shape == want.shape
        _assert_within(got, want, absp, N)
        iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(iv), again.view(iv)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_masked_dx_inf_under_zero_mask_is_nan(dtype):
    """The dgrad's mask multiplies (never selects): an inf weight under a
    zero mask gives NaN in exactly the plain version's places (dx's column
    of the weight's row), through K14 and K17, split and unsplit; a NaN
    weight under a one the same."""
    dev = _cuda()
    _, w, g, m, _ = _masked_problem((16, 256, 128), dtype, dev)
    w[5, 7], m[5, 7] = float("inf"), False
    w[9, 30], m[9, 30] = float("nan"), True
    want = torch.isnan(tmm.masked_dx_plain(g, w, m))
    assert bool(want[:, 5].all()) and bool(want[:, 9].all())
    for plan in ((16, 64, 1), (16, 64, 2), (128, 128, 1), (128, 128, 2), (128, 64, 3)):
        assert torch.equal(torch.isnan(tmm.masked_dx(g, w, m, bm=16, bk=128, plan=plan)),
                           want), plan
        got = tmm.grouped_masked_dx(g[None], w[None], m[None], bm=16, bk=128, plan=plan)
        assert torch.equal(torch.isnan(got[0]), want), plan


@pytest.mark.cuda
def test_cuda_masked_dx_has_no_spill():
    """No instantiation of the dgrad spills a register (``-Xptxas=-v``'s
    count, read back from the runtime), and each holds as many CTAs an SM
    as the forward's instantiation of the same tile."""
    _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        for bm, bn in tmm.FWD_TILES:
            info = tmm.fwd_launch_info(dtype, bm, bn, "dx")
            fwd = tmm.fwd_launch_info(dtype, bm, bn)
            assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1, (dtype, bm, bn, info)
            assert info["ctas_per_sm"] == fwd["ctas_per_sm"], (dtype, bm, bn, info, fwd)


@pytest.mark.cuda
def test_cuda_masked_dx_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in the dgrad too: at 2048 rows (danube's
    wi, 2560 x 6912, density 0.165: g @ (w * m)^T contracts over 6912) the
    kernel's RMS error against a float64 product is at most 8x the plain
    f32 product's (one-pass TF32 would be ~1000x)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(23)
    g = torch.randn(2048, 6912, device=dev, generator=gen)
    w = torch.randn(2560, 6912, device=dev, generator=gen) / 6912 ** 0.5
    m = torch.rand(2560, 6912, device=dev, generator=gen) < 0.165
    ref = g.double() @ (w * m).double().T
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    got = rms(tmm.masked_dx(g, w, m, bm=128, bk=128))
    assert got <= 8 * rms(tmm.masked_dx_plain(g, w, m)), got


# (G, M, K, N) of the wgrad x (G, M, K)^T @ g (G, M, N) -> dw (G, K, N):
# rows K = 64 (the 16 x 64 tile) with M off the 32-row slabs and N off the
# 64-column tile; K and N off the 128 tile with M 8.5 slabs; a grouped bank
# at 96 rows with K and N off the tile; a grouped bank at 16 rows
DW_SHAPES = [(1, 48, 64, 160), (1, 272, 400, 384), (4, 96, 208, 272), (3, 16, 256, 384)]


def _dw_plans(G, M, K, N, dtype):
    """Every plan the sweeps force at this wgrad shape (``fwd_candidates``
    on rows K, contraction M, columns N and the wgrad kernel's slots) and
    every built tile unsplit and split in 3 where M has 3 slabs."""
    bm, bn = tmm.fwd_tile(K, entry="dw")
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tmm.fwd_launch_info(dtype, bm, bn, "dw")["ctas_per_sm"])
    plans = set(tmm.fwd_candidates(K, M, N, G, dtype, slots, entry="dw"))
    plans |= {(tbm, tbn, n) for tbm, tbn in tmm.DW_TILES for n in (1, 3)
              if n <= -(-M // tmm.FWD_SLAB)}
    return sorted(plans)


def _dw(x, g, m, plan):
    if x.dim() == 3:
        return tmm.grouped_masked_dw(x, g, m, bn=16, bk=16, plan=plan)
    return tmm.masked_dw(x, g, m, bn=16, bk=16, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_masked_dw_every_plan_matches_plain(shape, dtype):
    """K15 (G = 1) and K18 under every forced plan (tile, split) element by
    element within ``matmul_error_bound`` of the plain version, exact zeros
    off the mask; a split counts one K15/K18 launch and one dw merge (and
    no forward or dgrad merge); two launches of one plan give the same
    bits."""
    dev = _cuda()
    G, M, K, N = shape
    rng = np.random.default_rng(37)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = f(rng.standard_normal((G, M, K)))
    g = f(rng.standard_normal((G, M, N)) / np.sqrt(M))
    mk = rng.random((G, K, N)) < 0.3
    mk[:, 3, :] = False
    mk[:, :, 5] = False
    m = torch.from_numpy(mk).to(dev)
    if G == 1:
        x, g, m = x[0], g[0], m[0]
    want = (tmm.masked_dw_plain if G == 1 else tmm.grouped_masked_dw_plain)(x, g, m)
    absp = (x.float().abs().transpose(-1, -2) @ g.float().abs()) * m
    read = lambda: [tmm.dw_launches, tmm.gdw_launches, tmm.dw_merge_launches,
                    tmm.fwd_merge_launches + tmm.dx_merge_launches]
    for plan in _dw_plans(G, M, K, N, dtype):
        n = read()
        got = _dw(x, g, m, plan)
        again = _dw(x, g, m, plan)
        torch.cuda.synchronize()
        k = 2 if plan[2] > 1 else 0
        assert read() == ([n[0] + 2, n[1], n[2] + k, n[3]] if G == 1
                          else [n[0], n[1] + 2, n[2] + k, n[3]]), plan
        assert got.dtype == dtype and got.shape == want.shape
        _assert_within(got, want, absp, M)
        assert not got[~m].any(), plan
        iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(iv), again.view(iv)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_masked_dw_inf_under_zero_mask_is_nan(dtype):
    """The wgrad's mask multiplies the f32 sum (never selects): an inf in x
    (row 37, column 5) gives NaN in the plain version's places -- dw's row 5
    wherever the mask is 0 -- and a NaN in g NaN down dw's column, through
    K15 and K18, split (the merge masks after the ordered sum) and unsplit:
    NaN and +-inf in exactly the plain version's places, in bf16 and in f32
    (3xTF32 splits an inf into hi = 0 and lo = inf, so it meets only the
    other operand's hi)."""
    dev = _cuda()
    x, _, g, _, b = _masked_problem((96, 256, 128), dtype, dev)
    x[37, 5] = float("inf")
    g[60, 30] = float("nan")
    plain = tmm.masked_dw_plain(x, g, b)
    want = torch.isnan(plain)
    assert torch.equal(want[5], ~b[5] | (torch.arange(128, device=dev) == 30))
    assert bool(want[:, 30].all())

    def held(got, plan):
        assert torch.equal(torch.isnan(got), want), plan
        assert torch.equal(torch.isinf(got), torch.isinf(plain)), plan
        inf = torch.isinf(plain)
        assert torch.equal(got[inf].float(), plain[inf].float()), plan

    for plan in ((128, 64, 1), (128, 64, 2), (128, 128, 1), (128, 128, 2), (128, 64, 3)):
        held(tmm.masked_dw(x, g, b, bn=128, bk=128, plan=plan), plan)
        held(tmm.grouped_masked_dw(x[None], g[None], b[None], bn=128, bk=128, plan=plan)[0],
             plan)


@pytest.mark.cuda
def test_cuda_masked_dw_has_no_spill():
    """No instantiation of the wgrad spills a register (``-Xptxas=-v``'s
    count, read back from the runtime), each holds at least as many CTAs an
    SM as the forward's instantiation of the same tile, and its shared
    bytes are a ring of at least two ColsA and dense B stages (no mask
    slabs) and the output tile's mask, rows padded by 16 bytes.  The
    16-row tile is not built for the wgrad: its launch info and a plan
    that forces it raise."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        e = torch.finfo(dtype).bits // 8
        with pytest.raises(RuntimeError):
            tmm.fwd_launch_info(dtype, 16, 64, "dw")
        x = torch.zeros(32, 64, device=dev, dtype=dtype)
        m = torch.ones(64, 64, device=dev, dtype=torch.bool)
        with pytest.raises(ValueError, match="built tile"):
            tmm.masked_dw(x, x, m, bn=64, bk=64, plan=(16, 64, 1))
        for bm, bn in tmm.DW_TILES:
            info = tmm.fwd_launch_info(dtype, bm, bn, "dw")
            fwd = tmm.fwd_launch_info(dtype, bm, bn)
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, bm, bn, info)
            assert info["ctas_per_sm"] >= fwd["ctas_per_sm"], (dtype, bm, bn, info, fwd)
            stage, ring = 32 * ((bm + 8) + (bn + 8)) * e, info["smem_bytes"] - bm * (bn + 16)
            assert ring % stage == 0 and ring >= 2 * stage, (dtype, bm, bn, info)


@pytest.mark.cuda
def test_cuda_masked_dw_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in the wgrad too: at 2048 rows (danube's
    wi, 2560 x 6912, a superset of density 0.25: x^T @ g contracts over the
    2048 rows) the kernel's RMS error against a float64 product is at most
    8x the plain f32 product's (one-pass TF32 would be ~1000x)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(2048, 2560, device=dev, generator=gen)
    g = torch.randn(2048, 6912, device=dev, generator=gen) / 2048 ** 0.5
    m = torch.rand(2560, 6912, device=dev, generator=gen) < 0.25
    ref = (x.double().T @ g.double()) * m
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    got = rms(tmm.masked_dw(x, g, m, bn=128, bk=128))
    assert got <= 8 * rms(tmm.masked_dw_plain(x, g, m)), got


FUSED_TYPES = [(torch.bfloat16, torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.float32, torch.float32),
               (torch.float32, torch.bfloat16, torch.float32),
               (torch.float32, torch.float32, torch.float32)]


def _dw_fused_plans(G, M, K, N, dtype):
    """Every plan the sweeps force at this K19/K20 shape (``fwd_candidates``
    with ``entry="dw_fused"`` on the fused kernel's slots) and every built
    tile unsplit and split in 3 where M has 3 slabs."""
    bm, bn = tmm.fwd_tile(K, entry="dw_fused")
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tmm.fwd_launch_info(dtype, bm, bn, "dw_fused")["ctas_per_sm"])
    plans = set(tmm.fwd_candidates(K, M, N, G, dtype, slots, entry="dw_fused"))
    plans |= {(tbm, tbn, n) for tbm, tbn in tmm.DW_TILES for n in (1, 3)
              if n <= -(-M // tmm.FWD_SLAB)}
    return sorted(plans)


def _dw_fused_problem(shape, dtype, mdt, dev, seed=53):
    """x, g, w in ``dtype``, mom in ``mdt`` and a wgrad mask with an empty row
    and column (and for G > 1 a fully masked group), on ``dev``; 2-D for G
    = 1."""
    G, M, K, N = shape
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    mk = rng.random((G, K, N)) < 0.3
    mk[:, 3, :] = False
    mk[:, :, 5] = False
    if G > 1:
        mk[1] = False
    m = torch.from_numpy(mk).to(dev)
    x = f(rng.standard_normal((G, M, K))).to(dtype)
    g = f(rng.standard_normal((G, M, N)) / np.sqrt(M)).to(dtype)
    w = f(rng.standard_normal((G, K, N)) / np.sqrt(K)).to(dtype)
    mom = (0.1 * f(rng.standard_normal((G, K, N)))).to(mdt)
    if G == 1:
        x, g, w, mom, m = x[0], g[0], w[0], mom[0], m[0]
    return x, g, w, mom, m


def _dw_fused(x, g, m, w, mom, seed, plan, sr, out_dtype=None):
    fn = tmm.grouped_masked_dw_fused if x.dim() == 3 else tmm.masked_dw_fused
    return fn(x, g, m, w, mom, seed, mu=0.9, wd=1e-4, sr=sr, bn=16, bk=16, plan=plan,
              out_dtype=out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("types", FUSED_TYPES)
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_masked_dw_fused_every_plan_matches_plain(shape, types):
    """K19 (G = 1) and K20 under every forced plan (tile, split) on the
    wgrad's shapes, each of the six type combinations: without sr within
    ``fused_error_bound`` of the plain version; with sr bit for bit the
    plain ``sr_to_bf16`` of the kernel's own f32 m_new under the same plan
    (the f32-output entry, sr off) and on the bf16 grid; exact zeros off
    the mask (a fully masked group too); a split counts one K19/K20 launch
    and one fused merge (no dw merge); two launches of one plan give the
    same bits."""
    dev = _cuda()
    dtype, mdt, odt = types
    G, M, K, N = shape
    x, g, w, mom, m = _dw_fused_problem(shape, dtype, mdt, dev)
    seed = 0x9E3779B9
    want = tmm.masked_dw_fused_plain(x, g, m, w, mom, seed, mu=0.9, wd=1e-4, sr=False,
                                     out_dtype=odt)
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, w, acc, m)
    gid = tmm._gid(K, N, dev, G=G if G > 1 else None)
    read = lambda: [tmm.fused_launches, tmm.g_fused_launches, tmm.dw_fused_merge_launches,
                    tmm.dw_merge_launches]
    iv = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for plan in _dw_fused_plans(G, M, K, N, dtype):
        n = read()
        got = _dw_fused(x, g, m, w, mom, seed, plan, False, odt)
        again = _dw_fused(x, g, m, w, mom, seed, plan, False, odt)
        torch.cuda.synchronize()
        k = 2 if plan[2] > 1 else 0
        assert read() == ([n[0] + 2, n[1], n[2] + k, n[3]] if G == 1
                          else [n[0], n[1] + 2, n[2] + k, n[3]]), plan
        assert got.dtype == odt and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= bound).all()), (plan, float((diff / bound.clamp_min(1e-30)).max()))
        assert not got[~m].any(), plan
        assert torch.equal(got.view(iv[odt]), again.view(iv[odt])), plan
        raw = _dw_fused(x, g, m, w, mom, seed, plan, False, torch.float32)
        sr = _dw_fused(x, g, m, w, mom, seed, plan, True, odt)
        want_sr = tmm.sr_to_bf16(raw, seed, gid).to(odt)
        assert torch.equal(sr.view(iv[odt]), want_sr.view(iv[odt])), plan
        assert torch.equal(sr.float(), sr.to(torch.bfloat16).float()), plan
        assert not sr[~m].any(), plan


@pytest.mark.cuda
@pytest.mark.parametrize("types", FUSED_TYPES)
@pytest.mark.parametrize("shape", [(1, 16, 64, 96), (3, 8, 48, 160)])
def test_cuda_dw_fused_merge_matches_plain(shape, types):
    """K19/K20's split merge (``dw_fused_merge``: the ordered sum of the f32
    partials, then the momentum epilogue, the mask and sr, one rounding) bit
    for bit its plain version, sr off and on, each type combination, a fully
    masked group among three; one launch each."""
    dev = _cuda()
    dtype, mdt, odt = types
    n_split, G, K, N = shape
    x, g, w, mom, m = _dw_fused_problem((G, 32, K, N), dtype, mdt, dev)
    if G == 1:
        w, mom, m = w[None], mom[None], m[None]
    part = torch.randn(n_split, G, K, N, device=dev)
    iv = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for sr in (False, True):
        n = tmm.dw_fused_merge_launches
        out = torch.empty(G, K, N, dtype=odt, device=dev)
        got = tmm.dw_fused_merge(part, m, w, mom, out, 0xDEADBEEF, mu=0.9, wd=1e-4, sr=sr)
        want = tmm.masked_dw_fused_merge_plain(part, m, w, mom, 0xDEADBEEF, mu=0.9, wd=1e-4,
                                               sr=sr, out_dtype=odt)
        torch.cuda.synchronize()
        assert tmm.dw_fused_merge_launches == n + 1
        assert torch.equal(got.view(iv[odt]), want.view(iv[odt])), sr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_masked_dw_fused_inf_under_zero_mask_is_nan(dtype):
    """K19/K20's mask multiplies the momentum (never selects): an inf in x
    (row 37, column 5) gives NaN wherever m_new's row 5 is masked out and
    +-inf where it is kept, as the plain version, split and unsplit, in
    bf16 and in f32 (3xTF32 with the exact re-walk)."""
    dev = _cuda()
    x, g, w, mom, m = _dw_fused_problem((1, 96, 256, 128), dtype, torch.bfloat16, dev)
    x[37, 5] = float("inf")
    plain = tmm.masked_dw_fused_plain(x, g, m, w, mom, 1, mu=0.9, wd=1e-4, sr=False)
    assert torch.equal(torch.isnan(plain[5]), ~m[5])
    for plan in ((128, 64, 1), (128, 128, 2), (128, 64, 3)):
        for got in (_dw_fused(x, g, m, w, mom, 1, plan, False),
                    _dw_fused(x[None], g[None], m[None], w[None], mom[None], 1, plan,
                              False)[0]):
            assert torch.equal(torch.isnan(got), torch.isnan(plain)), plan
            assert torch.equal(torch.isinf(got), torch.isinf(plain)), plan
            inf = torch.isinf(plain)
            assert torch.equal(got[inf].float(), plain[inf].float()), plan


@pytest.mark.cuda
def test_cuda_masked_dw_fused_has_no_spill():
    """No instantiation of K19/K20's kernel (six type combinations, the two
    wgrad tiles) spills a register, each holds at least one CTA an SM, and
    its shared bytes are the wgrad's: a ring of ColsA and dense B stages
    and the output tile's mask.  No kernel of the library, the merges
    included, spills (ptxas's report in the build log).  The 16-row tile is
    not built: its launch info and a plan that forces it raise."""
    from repro_torch.kernels import _build

    dev = _cuda()
    _build.load("masked_matmul")
    log = _build.lib_path("masked_matmul").with_suffix(".log").read_text()
    reports = [ln.strip() for ln in log.splitlines() if "spill stores" in ln]
    spills = [ln for ln in reports if ", 0 bytes spill stores, 0 bytes spill loads" not in ln]
    assert reports and not spills, spills
    for dtype, mdt, odt in FUSED_TYPES:
        with pytest.raises(RuntimeError):
            tmm.fwd_launch_info(dtype, 16, 64, "dw_fused", mdt, odt)
        for bm, bn in tmm.DW_TILES:
            info = tmm.fwd_launch_info(dtype, bm, bn, "dw_fused", mdt, odt)
            dw = tmm.fwd_launch_info(dtype, bm, bn, "dw")
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, mdt, odt, info)
            assert info["ctas_per_sm"] >= 1 and info["smem_bytes"] == dw["smem_bytes"], (
                dtype, mdt, odt, bm, bn, info, dw)
    x, w = torch.zeros(32, 64, device=dev), torch.zeros(64, 64, device=dev)
    m = torch.ones(64, 64, device=dev, dtype=torch.bool)
    with pytest.raises(ValueError, match="built tile"):
        tmm.masked_dw_fused(x, x, m, w, w, 0, mu=0.9, wd=0.0, sr=False, bn=64, bk=64,
                            plan=(16, 64, 1))


@pytest.mark.cuda
def test_cuda_masked_dw_fused_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in K19 too: at 2048 rows (danube's wi, 2560
    x 6912, a superset of density 0.25) the RMS error of the new momentum
    (sr off, f32 state) against a float64 epilogue on a float64 product is
    at most 8x the plain f32 version's."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2048, 2560, device=dev, generator=gen)
    g = torch.randn(2048, 6912, device=dev, generator=gen) / 2048 ** 0.5
    m = torch.rand(2560, 6912, device=dev, generator=gen) < 0.25
    w = torch.randn(2560, 6912, device=dev, generator=gen) / 2560 ** 0.5
    mom = 0.1 * torch.randn(2560, 6912, device=dev, generator=gen)
    ref = (0.9 * mom.double() + x.double().T @ g.double() + 1e-4 * w.double()) * m
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    kw = dict(mu=0.9, wd=1e-4, sr=False)
    got = rms(tmm.masked_dw_fused(x, g, m, w, mom, 0, bn=128, bk=128, **kw))
    assert got <= 8 * rms(tmm.masked_dw_fused_plain(x, g, m, w, mom, 0, **kw)), got


# (G, M, K, N, bk, bn, dead groups) of the block-sparse wgrad x (G, M, K)^T
# @ g (G, M, N) -> dw (G, K, N) on a superset pack: 128 x 128 blocks with M
# off the 32-row slabs (8.5 slabs); 128 x 64 blocks; 16 x 16 and 32 x 32
# blocks (the training-step tests' 16) in the 128 x 64 tile; a 64 x 32
# block; a grouped bank at 16 rows (one slab) and one at 96 with dead
# groups
BS_DW_SHAPES = [(1, 272, 384, 512, 128, 128, ()), (1, 160, 256, 384, 128, 64, ()),
                (1, 48, 64, 96, 16, 16, ()), (1, 96, 128, 160, 32, 32, ()),
                (1, 80, 192, 128, 64, 32, ()), (3, 16, 256, 384, 128, 128, ()),
                (5, 96, 64, 96, 16, 16, (1, 3))]


def _bs_dw_problem(shape, dtype, dev, seed=41):
    """x, g in ``dtype`` on ``dev`` (2-D for G = 1), a superset block mask
    with an empty block column (and the dead groups empty), its stacked CSC
    on ``dev`` and the dense (G, K, N) bool of its blocks."""
    G, M, K, N, bk, bn, dead = shape
    rng = np.random.default_rng(seed)
    bm = rng.random((G, K // bk, N // bn)) < 0.4
    bm[:, :, 0] = False
    bm[:, 0, -1] = True
    for grp in dead:
        bm[grp] = False
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = f(rng.standard_normal((G, M, K)))
    g = f(rng.standard_normal((G, M, N)) / np.sqrt(M))
    idx, cnt = (torch.from_numpy(a).to(dev) for a in pack_group_mask(bm))
    live = torch.from_numpy(np.repeat(np.repeat(bm, bk, 1), bn, 2)).to(dev)
    if G == 1:
        x, g, idx, cnt, live = x[0], g[0], idx[0], cnt[0], live[0]
    return x, g, idx, cnt, live, int(bm.sum())


def _bs_dw(x, g, idx, cnt, bk, bn, plan=None, live=None):
    if x.dim() == 3:
        return tbsm.grouped_block_sparse_dw(x, g, idx, cnt, bn=bn, bk=bk, plan=plan, live=live)
    return tbsm.block_sparse_dw(x, g, idx, cnt, bn=bn, bk=bk, plan=plan, live=live)


def _bs_dw_plans(G, M, K, N, bn, dtype, live):
    """Every plan the sweeps force at this shape (``dw_candidates`` on the
    kernel's slots) and every built tile that holds the block unsplit and
    split in 3 where M has 3 slabs."""
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tbsm.dw_launch_info(dtype, *tbsm.dw_tile(bn))["ctas_per_sm"])
    plans = set(tbsm.dw_candidates(M, K, N, G, dtype, slots, bn=bn, live=live))
    plans |= {(a, b, n) for a, b in tmm.DW_TILES if b >= bn for n in (1, 3)
              if n <= -(-M // tmm.FWD_SLAB)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BS_DW_SHAPES)
def test_cuda_bs_dw_every_plan_matches_plain(shape, dtype):
    """K3 (G = 1) and K6 on the GEMM core under every forced plan (tile,
    split) element by element within ``matmul_error_bound`` of the plain
    version; exact +0.0 off the superset and for a dead group; a split
    counts one K3/K6 launch and one merge (``dw_merge_launches``), an
    unsplit launch none; two launches of one plan give the same bits; the
    plan's own pick, from the live blocks or from every slot, likewise."""
    dev = _cuda()
    G, M, K, N, bk, bn, dead = shape
    x, g, idx, cnt, live, nnz = _bs_dw_problem(shape, dtype, dev)
    want = (tbsm.block_sparse_dw_plain if G == 1 else tbsm.grouped_block_sparse_dw_plain)(
        x, g, idx, cnt, bk, bn)
    absp = (tbsm.block_sparse_dw_plain if G == 1 else tbsm.grouped_block_sparse_dw_plain)(
        x.float().abs(), g.float().abs(), idx, cnt, bk, bn)
    read = lambda: [tbsm.dw_launches, tbsm.gdw_launches, tbsm.dw_merge_launches]
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for plan in _bs_dw_plans(G, M, K, N, bn, dtype, nnz) + [None]:
        n = read()
        got = _bs_dw(x, g, idx, cnt, bk, bn, plan, live=nnz)
        again = _bs_dw(x, g, idx, cnt, bk, bn, plan, live=nnz)
        torch.cuda.synchronize()
        if plan is not None:
            k = 2 if plan[2] > 1 else 0
            assert read() == ([n[0] + 2, n[1], n[2] + k] if G == 1
                              else [n[0], n[1] + 2, n[2] + k]), plan
        assert got.dtype == dtype and got.shape == want.shape
        _assert_within(got, want, absp, M)
        off = got[~live].float()
        assert not off.any() and not bool(torch.signbit(off).any()), plan
        for grp in dead:
            assert not got[grp].float().any(), plan
        assert torch.equal(got.view(iv), again.view(iv)), plan
    _assert_within(_bs_dw(x, g, idx, cnt, bk, bn), want, absp, M)  # every slot counted


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_dw_inf_and_nan_in_the_plain_places(dtype):
    """An inf in x (row 37, column 5) and a NaN in g (column 70): K3 and K6,
    split (the merge sums the packed partials in order) and unsplit, give
    NaN and +-inf in exactly the plain version's places -- +-inf on the
    superset's blocks of dw's row 5, NaN down its column 70 -- and +0.0 off
    the superset, in bf16 and in f32 (3xTF32 walks such a tile again with
    the exact split)."""
    dev = _cuda()
    x, g, idx, cnt, live, nnz = _bs_dw_problem((1, 96, 256, 128, 32, 32, ()), dtype, dev)
    x[37, 5] = float("inf")
    g[60, 70] = float("nan")
    plain = tbsm.block_sparse_dw_plain(x, g, idx, cnt, 32, 32)
    assert bool(torch.isinf(plain[5]).any()) and bool(torch.isnan(plain[:, 70]).any())

    def held(got, plan):
        assert torch.equal(torch.isnan(got), torch.isnan(plain)), plan
        assert torch.equal(torch.isinf(got), torch.isinf(plain)), plan
        inf = torch.isinf(plain)
        assert torch.equal(got[inf].float(), plain[inf].float()), plan
        assert not got[~live].float().any(), plan

    for plan in ((128, 64, 1), (128, 64, 2), (128, 128, 1), (128, 128, 3)):
        held(tbsm.block_sparse_dw(x, g, idx, cnt, bn=32, bk=32, plan=plan), plan)
        held(tbsm.grouped_block_sparse_dw(x[None], g[None], idx[None], cnt[None], bn=32, bk=32,
                                          plan=plan)[0], plan)


@pytest.mark.cuda
def test_cuda_bs_dw_has_no_spill():
    """No instantiation of K3/K6's kernel spills a register (``-Xptxas=-v``'s
    count, read back from the runtime), each holds at least as many CTAs an
    SM as the masked wgrad's on the same tile, and its shared bytes are a
    ring of at least two ColsA and dense B stages (no mask of any kind).  A
    plan whose tile does not hold the block, or that is not built, raises."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        e = torch.finfo(dtype).bits // 8
        for bm, bn in tmm.DW_TILES:
            info = tbsm.dw_launch_info(dtype, bm, bn)
            masked = tmm.fwd_launch_info(dtype, bm, bn, "dw")
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, bm, bn, info)
            assert info["ctas_per_sm"] >= masked["ctas_per_sm"], (dtype, bm, bn, info, masked)
            stage = 32 * ((bm + 8) + (bn + 8)) * e
            assert info["smem_bytes"] % stage == 0 and info["smem_bytes"] >= 2 * stage
        with pytest.raises(RuntimeError):
            tbsm.dw_launch_info(dtype, 16, 64)
        x = torch.zeros(32, 256, device=dev, dtype=dtype)
        idx = torch.zeros(2, 1, dtype=torch.int32, device=dev)
        cnt = torch.ones(2, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_dw(x, x, idx, cnt, bn=128, bk=128, plan=(128, 64, 1))
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_dw(x, x, idx, cnt, bn=128, bk=128, plan=(16, 64, 1))
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_dw(x, x, idx, cnt, bn=128, bk=128, plan=(128, 128, 2))


@pytest.mark.cuda
def test_cuda_bs_dw_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in K3: at 2048 rows on danube's MLP wi
    shape (2560 x 6912) with a superset of density 0.26, under the plan's
    split, the kernel's RMS error against a float64 product is at most 8x
    the plain f32 product's (one-pass TF32 would be ~1000x)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2048, 2560, device=dev, generator=gen)
    g = torch.randn(2048, 6912, device=dev, generator=gen) / 2048 ** 0.5
    bm = torch.rand(20, 54, device=dev, generator=gen) < 0.26
    idx, cnt = (torch.from_numpy(a).to(dev) for a in pack_np(bm.cpu().numpy()))
    live = bm.repeat_interleave(128, 0).repeat_interleave(128, 1)
    ref = torch.where(live, x.double().T @ g.double(), 0.0)
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    n = tbsm.dw_merge_launches
    got = rms(tbsm.block_sparse_dw(x, g, idx, cnt, bn=128, bk=128, live=int(bm.sum())))
    assert tbsm.dw_merge_launches == n + 1  # the plan splits ~280 blocks on 132 SMs
    assert got <= 8 * rms(tbsm.block_sparse_dw_plain(x, g, idx, cnt, 128, 128)), got


def _bs_fused(x, g, idx, cnt, w, mom, bk, bn, plan, sr, out_dtype=None, live=None):
    fn = tbsm.grouped_block_sparse_dw_fused if x.dim() == 3 else tbsm.block_sparse_dw_fused
    return fn(x, g, idx, cnt, w, mom, 0x9E3779B9, mu=0.9, wd=1e-4, sr=sr, bn=bn, bk=bk,
              out_dtype=out_dtype, plan=plan, live=live)


def _bs_fused_plans(G, M, K, N, bn, types, live):
    """Every plan the sweeps force at this K7/K8 shape (``dw_candidates`` on
    the fused kernel's slots for these mom and output types) and every
    built tile that holds the block unsplit and split in 3 where M has 3
    slabs."""
    dtype, mdt, odt = types
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tbsm.dw_launch_info(dtype, *tbsm.dw_tile(bn), mdt, odt)["ctas_per_sm"])
    plans = set(tbsm.dw_candidates(M, K, N, G, dtype, slots, bn=bn, live=live))
    plans |= {(a, b, n) for a, b in tmm.DW_TILES if b >= bn for n in (1, 3)
              if n <= -(-M // tmm.FWD_SLAB)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("types", FUSED_TYPES)
@pytest.mark.parametrize("shape", BS_DW_SHAPES)
def test_cuda_bs_dw_fused_every_plan_matches_plain(shape, types):
    """K7 (G = 1) and K8, K3/K6's kernel with the momentum epilogue, under
    every forced plan (tile, split) and the plan's own pick: sr off element
    by element within ``fused_error_bound`` of the plain version, exact
    +0.0 off the superset (where w holds an inf) and for a dead group; sr
    on bit for bit ``sr_to_bf16`` of the same plan's own f32 m_new and on
    the bf16 grid; two launches of one plan the same bits; each call one
    K7/K8 launch and, for a split, one fused merge (no K3/K6 merge)."""
    dev = _cuda()
    dtype, mdt, odt = types
    G, M, K, N, bk, bn, dead = shape
    x, g, idx, cnt, live, nnz = _bs_dw_problem(shape, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(G + M + K)
    w = (torch.randn(live.shape, device=dev, generator=gen) / K ** 0.5).to(dtype)
    mom = (0.1 * torch.randn(live.shape, device=dev, generator=gen)).to(mdt)
    w[..., 3, 5] = float("inf")  # block column 0 is empty: off the superset
    assert not bool(live[..., 3, 5].any())
    plain = (tbsm.block_sparse_dw_fused_plain if G == 1
             else tbsm.grouped_block_sparse_dw_fused_plain)
    want = plain(x, g, idx, cnt, w, mom, 0x9E3779B9, mu=0.9, wd=1e-4, sr=False, bk=bk, bn=bn,
                 out_dtype=odt)
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, torch.where(live, w, 0),
                                  acc, live)
    gid = tmm._gid(K, N, dev, G=G if G > 1 else None)
    read = lambda: [tbsm.fused_launches, tbsm.g_fused_launches, tbsm.dw_fused_merge_launches,
                    tbsm.dw_merge_launches]
    iv = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for plan in _bs_fused_plans(G, M, K, N, bn, types, nnz) + [None]:
        n = read()
        got = _bs_fused(x, g, idx, cnt, w, mom, bk, bn, plan, False, odt, nnz)
        again = _bs_fused(x, g, idx, cnt, w, mom, bk, bn, plan, False, odt, nnz)
        raw = _bs_fused(x, g, idx, cnt, w, mom, bk, bn, plan, False, torch.float32, nnz)
        sr = _bs_fused(x, g, idx, cnt, w, mom, bk, bn, plan, True, odt, nnz)
        torch.cuda.synchronize()
        if plan is not None:
            k = 4 if plan[2] > 1 else 0
            assert read() == ([n[0] + 4, n[1], n[2] + k, n[3]] if G == 1
                              else [n[0], n[1] + 4, n[2] + k, n[3]]), plan
        assert got.dtype == odt and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= bound).all()), (plan, float((diff / bound.clamp_min(1e-30)).max()))
        assert torch.equal(got.view(iv[odt]), again.view(iv[odt])), plan
        assert torch.equal(sr.float(), tmm.sr_to_bf16(raw, 0x9E3779B9, gid).to(odt).float())
        assert torch.equal(sr.float(), sr.to(torch.bfloat16).float()), plan
        for t in (got, sr):
            off = t[~live].float()
            assert not off.any() and not bool(torch.signbit(off).any()), plan
            for grp in dead:
                assert not t[grp].float().any(), plan


@pytest.mark.cuda
def test_cuda_bs_dw_fused_has_no_spill():
    """No instantiation of K7/K8's kernel (six type combinations, the two
    wgrad tiles) spills a register, each holds at least as many CTAs an SM
    as K19/K20's on the tile and K3/K6's shared bytes (the momentum tiles
    are staged into the ring); no kernel of the library, the merges
    included, spills (ptxas's report in the build log)."""
    from repro_torch.kernels import _build

    _cuda()
    _build.load("block_sparse_bwd")
    log = _build.lib_path("block_sparse_bwd").with_suffix(".log").read_text()
    reports = [ln.strip() for ln in log.splitlines() if "spill stores" in ln]
    spills = [ln for ln in reports if ", 0 bytes spill stores, 0 bytes spill loads" not in ln]
    assert reports and not spills, spills
    for dtype, mdt, odt in FUSED_TYPES:
        for bm, bn in tmm.DW_TILES:
            info = tbsm.dw_launch_info(dtype, bm, bn, mdt, odt)
            k3 = tbsm.dw_launch_info(dtype, bm, bn)
            k19 = tmm.fwd_launch_info(dtype, bm, bn, "dw_fused", mdt, odt)
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, mdt, odt, info)
            assert info["smem_bytes"] == k3["smem_bytes"], (dtype, mdt, odt, bm, bn, info, k3)
            assert info["ctas_per_sm"] >= k19["ctas_per_sm"], (dtype, mdt, odt, bm, bn, info)


@pytest.mark.cuda
def test_cuda_bs_dw_fused_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in K7 and K8: K7 at 2048 rows on danube's
    MLP wi shape (2560 x 6912, a superset of density 0.26, under the plan's
    split) and K8 on a bank of 8 of qwen2-moe's wi (2048 x 1408) at C = 256
    rows: the RMS error of the f32 new momentum (sr off, f32 state) against
    a float64 epilogue on a float64 product is at most 8x the plain f32
    version's."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(37)
    kw = dict(mu=0.9, wd=1e-4, sr=False, bn=128, bk=128)
    for G, M, K, N in ((0, 2048, 2560, 6912), (8, 256, 2048, 1408)):
        lead = (G,) if G else ()
        x = torch.randn(*lead, M, K, device=dev, generator=gen)
        g = torch.randn(*lead, M, N, device=dev, generator=gen) / M ** 0.5
        bm = torch.rand(*lead, K // 128, N // 128, device=dev, generator=gen) < 0.26
        idx, cnt = (torch.from_numpy(a).to(dev) for a in (
            pack_group_mask(bm.cpu().numpy()) if G else pack_np(bm.cpu().numpy())))
        live = bm.repeat_interleave(128, -2).repeat_interleave(128, -1)
        w = torch.randn(*lead, K, N, device=dev, generator=gen) / K ** 0.5
        mom = 0.1 * torch.randn(*lead, K, N, device=dev, generator=gen)
        ref = torch.where(live, 0.9 * mom.double() + x.double().transpose(-1, -2) @ g.double()
                          + 1e-4 * w.double(), 0.0)
        rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
        fn, plain = ((tbsm.grouped_block_sparse_dw_fused, tbsm.grouped_block_sparse_dw_fused_plain)
                     if G else (tbsm.block_sparse_dw_fused, tbsm.block_sparse_dw_fused_plain))
        got = rms(fn(x, g, idx, cnt, w, mom, 0, live=int(bm.sum()), **kw))
        assert got <= 8 * rms(plain(x, g, idx, cnt, w, mom, 0, **kw)), (G, got)


BS_FWD_SHAPES = [(1, 16, 512, 384, 128, 128, ()), (1, 200, 512, 256, 128, 128, ()),
                 (1, 48, 96, 64, 16, 16, ()), (1, 96, 160, 96, 32, 32, ()),
                 (1, 80, 192, 128, 64, 32, ()), (3, 16, 256, 384, 128, 128, ()),
                 (5, 96, 64, 96, 16, 16, (1, 3)), (1, 16, 12288, 1024, 128, 128, ())]


def _bs_fwd_problem(shape, dtype, dev, seed=43):
    """x (G, Mp, K) (rows zero-padded to 16) and w (G, K, N), zero off a
    block mask with an empty block column, uneven counts and the dead
    groups empty, in ``dtype`` on ``dev`` (2-D for G = 1); its stacked CSC,
    the dense (G, K, N) bool of its blocks and the live blocks."""
    G, M, K, N, bk, bn, dead = shape
    rng = np.random.default_rng(seed)
    bm = rng.random((G, K // bk, N // bn)) < 0.4
    bm[:, :, 0] = False
    bm[:, :, -1] = True
    for grp in dead:
        bm[grp] = False
    live = np.repeat(np.repeat(bm, bk, 1), bn, 2)
    Mp = -(-M // 16) * 16
    x = np.zeros((G, Mp, K), np.float32)
    x[:, :M] = rng.standard_normal((G, M, K))
    w = rng.standard_normal((G, K, N)) * live / np.sqrt(K)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    idx, cnt = (torch.from_numpy(a).to(dev) for a in pack_group_mask(bm))
    x, w, live = f(x), f(w), torch.from_numpy(live).to(dev)
    if G == 1:
        x, w, idx, cnt, live = x[0], w[0], idx[0], cnt[0], live[0]
    return x, w, idx, cnt, live, int(bm.sum())


def _bs_fwd(x, w, idx, cnt, bk, bn, plan=None, live=None):
    kw = dict(bm=16, bn=bn, bk=bk, plan=plan, live=live)
    if x.dim() == 3:
        return tbsm.grouped_block_sparse_matmul(x, w, idx, cnt, **kw)
    return tbsm.block_sparse_matmul(x, w, idx, cnt, **kw)


def _bs_fwd_plain(x, w, idx, cnt, bk, bn):
    fn = tbsm.grouped_block_sparse_matmul_plain if x.dim() == 3 else tbsm.block_sparse_matmul_plain
    return fn(x, w, idx, cnt, bk, bn)


def _bs_fwd_plans(G, Mp, K, N, bk, bn, dtype, live):
    """Every plan the sweeps force at this shape (K1/K4's
    ``fwd_candidates`` on the kernel's slots) and every built tile unsplit
    and split in 3 (odd splits: uneven and empty parts)."""
    tm, tn = tmm.fwd_tile(Mp, bn)
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tbsm.fwd_launch_info(dtype, tm, tn, K // bk)["ctas_per_sm"])
    plans = set(tbsm.fwd_candidates(Mp, K, N, G, dtype, slots, bk=bk, bn=bn, live=live))
    plans |= {(a, b, n) for a, b in tmm.FWD_TILES for n in (1, 3)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BS_FWD_SHAPES)
def test_cuda_bs_fwd_every_plan_matches_plain(shape, dtype):
    """K1 (G = 1) and K4 on the GEMM core's packed walk under every forced
    plan (tile, split) element by element within ``matmul_error_bound`` of
    the plain version (bf16 also within one ulp of the largest output), a
    split also of the plain version that follows it
    (``block_sparse_matmul_split_plain``); exact zeros in the empty block
    column and for a dead group; a split counts one K1/K4 launch and one
    merge (``fwd_merge_launches``), an unsplit launch none; two launches of
    one plan give the same bits; the plan's own pick, from the live blocks
    or from every slot, likewise."""
    dev = _cuda()
    G, M, K, N, bk, bn, dead = shape
    x, w, idx, cnt, live, nnz = _bs_fwd_problem(shape, dtype, dev)
    want = _bs_fwd_plain(x, w, idx, cnt, bk, bn)
    absp = _bs_fwd_plain(x.float().abs(), w.float().abs(), idx, cnt, bk, bn)
    read = lambda: [tbsm.launches, tbsm.g_launches, tbsm.fwd_merge_launches]
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for plan in _bs_fwd_plans(G, x.shape[-2], K, N, bk, bn, dtype, nnz) + [None]:
        n = read()
        got = _bs_fwd(x, w, idx, cnt, bk, bn, plan, live=nnz)
        again = _bs_fwd(x, w, idx, cnt, bk, bn, plan, live=nnz)
        torch.cuda.synchronize()
        if plan is not None:
            k = 2 if plan[2] > 1 else 0
            assert read() == ([n[0] + 2, n[1], n[2] + k] if G == 1
                              else [n[0], n[1] + 2, n[2] + k]), plan
        assert got.dtype == dtype and got.shape == want.shape
        splits = [want]
        if plan is not None and plan[2] > 1:
            splits.append(tbsm.block_sparse_matmul_split_plain(x, w, idx, cnt, bk, bn, plan[2]))
        for ref in splits:
            _assert_within(got, ref, absp, K)
            if dtype == torch.bfloat16:
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= 2.0 ** -7 * ref.float().abs().max().item(), plan
        assert not got[..., :bn].float().any(), plan  # the empty block column
        for grp in dead:
            assert not got[grp].float().any(), plan
        assert torch.equal(got.view(iv), again.view(iv)), plan
    _assert_within(_bs_fwd(x, w, idx, cnt, bk, bn), want, absp, K)  # every slot counted


@pytest.mark.cuda
def test_cuda_bs_fwd_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in K1 and K4: on danube's MLP wo shape
    (6912 -> 2560, density 0.26) at a decode step's 16 rows and at 1024
    rows, and on a bank of 8 (1408 -> 2048, 16 rows), each unsplit and
    split in 4, the kernel's RMS error against a float64 product on the
    pack's blocks is at most 8x the plain f32 version's (one-pass TF32 would
    be ~1000x)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(47)
    for G, M, K, N in ((1, 16, 6912, 2560), (1, 1024, 6912, 2560), (8, 16, 1408, 2048)):
        bm = torch.rand(G, K // 128, N // 128, device=dev, generator=gen) < 0.26
        live = bm.repeat_interleave(128, 1).repeat_interleave(128, 2)
        x = torch.randn(G, M, K, device=dev, generator=gen)
        w = torch.randn(G, K, N, device=dev, generator=gen) / K ** 0.5 * live
        idx, cnt = (torch.from_numpy(a).to(dev) for a in pack_group_mask(bm.cpu().numpy()))
        if G == 1:
            x, w, idx, cnt, live = x[0], w[0], idx[0], cnt[0], live[0]
        ref = torch.matmul(x.double(), torch.where(live, w.double(), 0.0))
        rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
        base = rms(_bs_fwd_plain(x, w, idx, cnt, 128, 128))
        for plan in (tmm.fwd_tile(M, 128) + (1,), tmm.fwd_tile(M, 128) + (4,)):
            got = rms(_bs_fwd(x, w, idx, cnt, 128, 128, plan, live=int(bm.sum())))
            assert got <= 8 * base, (G, M, plan, got, base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_fwd_nonfinite_x_reaches_only_the_blocks_that_read_it(dtype):
    """A -inf in x (row 9) in a K-block row that some block columns do not
    read (block column 0 reads none): K1 and K4, split and unsplit, leave
    those columns and every other row finite, as the plain version (the
    pack decides which rows of w are read; nothing multiplies an inactive
    block's zero); in f32 they give the plain version's +-inf and NaN in
    exactly its places: 3xTF32 walks such a tile again with the exact
    split."""
    dev = _cuda()
    x, w, idx, cnt, live, nnz = _bs_fwd_problem((1, 48, 256, 128, 32, 32, ()), dtype, dev)
    bm = live[::32, ::32]
    kb = int((bm.sum(1) < bm.shape[1] - 1).nonzero().flatten()[0])
    x[9, kb * 32 + 5] = float("-inf")
    plain = tbsm.block_sparse_matmul_plain(x, w, idx, cnt, 32, 32)
    reads = bm[kb].repeat_interleave(32)
    assert bool(torch.isinf(plain[9]).any())
    assert bool(torch.isfinite(plain[9][~reads]).all()) and (~reads).sum() >= 64
    for plan in ((16, 64, 1), (16, 64, 3), (128, 64, 1), (128, 128, 2)):
        for got in (tbsm.block_sparse_matmul(x, w, idx, cnt, bm=16, bn=32, bk=32, plan=plan),
                    tbsm.grouped_block_sparse_matmul(x[None], w[None], idx[None], cnt[None],
                                                     bm=16, bn=32, bk=32, plan=plan)[0]):
            assert torch.equal(torch.isfinite(got), torch.isfinite(plain)), plan
            if dtype == torch.float32:
                assert torch.equal(torch.isnan(got), torch.isnan(plain)), plan
                inf = torch.isinf(plain)
                assert torch.equal(got[inf], plain[inf]), plan


@pytest.mark.cuda
def test_cuda_bs_fwd_split_replays_in_a_cuda_graph():
    """A split K1 (its launch and its merge) captured in a CUDA graph and
    replayed gives the eager launch's bits; the counts are read on the
    device at each replay: with a column's count set to 0 in place (and x
    changed) the replay gives that column zeros and the eager result on the
    new inputs, bit for bit."""
    dev = _cuda()
    x, w, idx, cnt, live, nnz = _bs_fwd_problem((1, 16, 2048, 512, 128, 128, ()),
                                               torch.bfloat16, dev)
    run = lambda: tbsm.block_sparse_matmul(x, w, idx, cnt, bm=16, bn=128, bk=128,
                                           plan=(16, 64, 4), live=nnz)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), eager.view(torch.int16))
    x.copy_(torch.randn_like(x))
    cnt[2] = 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), run().view(torch.int16))
    assert not out[:, 256:384].float().any()


@pytest.mark.cuda
def test_cuda_bs_fwd_has_no_spill():
    """No instantiation of K1/K4's kernel spills a register (read back from
    the runtime), each holds at least as many CTAs an SM as the masked
    forward's on the same tile (no mask stage), and its shared bytes are a
    ring of at least two RowsA and dense B stages plus the id list.  A plan
    that is not built, or splits past FWD_MAX_SPLIT, raises."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        e = torch.finfo(dtype).bits // 8
        for bm, bn in tmm.FWD_TILES:
            info = tbsm.fwd_launch_info(dtype, bm, bn, 96)
            masked = tmm.fwd_launch_info(dtype, bm, bn, "fwd")
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, bm, bn, info)
            assert info["ctas_per_sm"] >= masked["ctas_per_sm"], (dtype, bm, bn, info, masked)
            stage = bm * (32 + 16 // e) * e + 32 * (bn + 8) * e
            ring = info["smem_bytes"] - 4 * 96
            assert ring % stage == 0 and ring >= 2 * stage, (dtype, bm, bn, info)
        x = torch.zeros(16, 256, device=dev, dtype=dtype)
        w = torch.zeros(256, 256, device=dev, dtype=dtype)
        idx = torch.zeros(2, 2, dtype=torch.int32, device=dev)
        cnt = torch.ones(2, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_matmul(x, w, idx, cnt, bm=16, bn=128, bk=128, plan=(64, 64, 1))
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_matmul(x, w, idx, cnt, bm=16, bn=128, bk=128,
                                     plan=(16, 64, tmm.FWD_MAX_SPLIT + 1))


# (G, M, K, N, bk, bn, dead groups) of the block-sparse dgrad g (G, M, N) @
# w (G, K, N)^T -> dx (G, M, K) on a CSR pack: 16 rows (the 16 x 64 tile);
# rows off the 128-row tile; 16 x 16, 32 x 32 and 32 x 64 blocks (column
# tiles of 64 that hold one block row each); a bank at 16 rows; a bank with
# dead groups; long lists (16 N-blocks a row)
BS_DX_SHAPES = [(1, 16, 384, 512, 128, 128, ()), (1, 200, 256, 512, 128, 128, ()),
                (1, 48, 96, 64, 16, 16, ()), (1, 96, 160, 96, 32, 32, ()),
                (1, 80, 128, 192, 32, 64, ()), (3, 16, 256, 384, 128, 128, ()),
                (5, 96, 64, 96, 16, 16, (1, 3)), (1, 256, 512, 2048, 128, 128, ())]


def _bs_dx_problem(shape, dtype, dev, seed=53):
    """g (G, Mp, N) (rows zero-padded to 16) and w (G, K, N), zero off a
    block mask with an empty block row (rcnt = 0), a full one, uneven
    counts and the dead groups empty, in ``dtype`` on ``dev`` (2-D for G =
    1); its stacked CSR, the dense (G, K, N) bool of its blocks and the
    live blocks."""
    from repro_torch.core.pack import pack_group_mask_rows

    G, M, K, N, bk, bn, dead = shape
    rng = np.random.default_rng(seed)
    bm = rng.random((G, K // bk, N // bn)) < 0.4
    bm[:, 0, :] = False
    bm[:, -1, :] = True
    for grp in dead:
        bm[grp] = False
    live = np.repeat(np.repeat(bm, bk, 1), bn, 2)
    Mp = -(-M // 16) * 16
    g = np.zeros((G, Mp, N), np.float32)
    g[:, :M] = rng.standard_normal((G, M, N))
    w = rng.standard_normal((G, K, N)) * live / np.sqrt(N)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    ridx, rcnt = (torch.from_numpy(a).to(dev) for a in pack_group_mask_rows(bm))
    g, w, live = f(g), f(w), torch.from_numpy(live).to(dev)
    if G == 1:
        g, w, ridx, rcnt, live = g[0], w[0], ridx[0], rcnt[0], live[0]
    return g, w, ridx, rcnt, live, int(bm.sum())


def _bs_dx(g, w, ridx, rcnt, bk, bn, plan=None, live=None):
    kw = dict(bm=16, bn=bn, bk=bk, plan=plan, live=live)
    if g.dim() == 3:
        return tbsm.grouped_block_sparse_dx(g, w, ridx, rcnt, **kw)
    return tbsm.block_sparse_dx(g, w, ridx, rcnt, **kw)


def _bs_dx_plain(g, w, ridx, rcnt, bk, bn):
    fn = tbsm.grouped_block_sparse_dx_plain if g.dim() == 3 else tbsm.block_sparse_dx_plain
    return fn(g, w, ridx, rcnt, bk, bn)


def _bs_dx_plans(G, Mp, K, N, bk, bn, dtype, live):
    """Every plan the sweeps force at this shape (``dx_candidates`` on the
    kernel's slots) and every built tile unsplit and split in 3 (odd
    splits: uneven and empty parts)."""
    tm, tn = tmm.fwd_tile(Mp, bk)
    slots = (torch.cuda.get_device_properties(0).multi_processor_count
             * tbsm.dx_launch_info(dtype, tm, tn, N // bn)["ctas_per_sm"])
    plans = set(tbsm.dx_candidates(Mp, K, N, G, dtype, slots, bk=bk, bn=bn, live=live))
    plans |= {(a, b, n) for a, b in tmm.FWD_TILES for n in (1, 3)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BS_DX_SHAPES)
def test_cuda_bs_dx_every_plan_matches_plain(shape, dtype):
    """K2 (G = 1) and K5 on the GEMM core's packed walk under every forced
    plan (tile, split) element by element within ``matmul_error_bound`` of
    the plain version (bf16 also within one ulp of the largest output), a
    split also of the plain version that follows it
    (``block_sparse_dx_split_plain``); a split counts one K2/K5 launch and
    one merge (``dx_merge_launches``), an unsplit launch none; the plan's
    own pick, from the live blocks or from every slot, likewise."""
    dev = _cuda()
    G, M, K, N, bk, bn, dead = shape
    g, w, ridx, rcnt, live, nnz = _bs_dx_problem(shape, dtype, dev)
    want = _bs_dx_plain(g, w, ridx, rcnt, bk, bn)
    absp = _bs_dx_plain(g.float().abs(), w.float().abs(), ridx, rcnt, bk, bn)
    read = lambda: [tbsm.dx_launches, tbsm.gdx_launches, tbsm.dx_merge_launches]
    for plan in _bs_dx_plans(G, g.shape[-2], K, N, bk, bn, dtype, nnz) + [None]:
        n = read()
        got = _bs_dx(g, w, ridx, rcnt, bk, bn, plan, live=nnz)
        torch.cuda.synchronize()
        if plan is not None:
            k = 1 if plan[2] > 1 else 0
            assert read() == ([n[0] + 1, n[1], n[2] + k] if G == 1
                              else [n[0], n[1] + 1, n[2] + k]), plan
        assert got.dtype == dtype and got.shape == want.shape
        splits = [want]
        if plan is not None and plan[2] > 1:
            splits.append(tbsm.block_sparse_dx_split_plain(g, w, ridx, rcnt, bk, bn, plan[2]))
        for ref in splits:
            _assert_within(got, ref, absp, N)
            if dtype == torch.bfloat16:
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= 2.0 ** -7 * ref.float().abs().max().item(), plan
    _assert_within(_bs_dx(g, w, ridx, rcnt, bk, bn), want, absp, N)  # every slot counted


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_dx_two_launches_give_the_same_bits(dtype):
    """No atomics and a fixed order: two launches of every forced plan of
    K2 and K5 give the same bits, split (the merge sums in order) or not."""
    dev = _cuda()
    for shape in (BS_DX_SHAPES[1], BS_DX_SHAPES[6]):
        G, M, K, N, bk, bn, _ = shape
        g, w, ridx, rcnt, _, nnz = _bs_dx_problem(shape, dtype, dev)
        iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for plan in _bs_dx_plans(G, g.shape[-2], K, N, bk, bn, dtype, nnz):
            a = _bs_dx(g, w, ridx, rcnt, bk, bn, plan, live=nnz)
            b = _bs_dx(g, w, ridx, rcnt, bk, bn, plan, live=nnz)
            assert torch.equal(a.view(iv), b.view(iv)), (shape, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_dx_empty_rows_store_zeros(dtype):
    """A K-block row with rcnt = 0 stores its zero dx columns into a dx
    that comes from torch.empty (here over memory just freed from a NaN
    tensor of its size), under every tile, split or not; setting a row's
    count to 0 in place zeroes its columns whatever its list holds."""
    dev = _cuda()
    g, w, ridx, rcnt, _, nnz = _bs_dx_problem((1, 96, 256, 384, 32, 32, ()), dtype, dev)
    rcnt = rcnt.clone()
    rcnt[3] = 0
    want = tbsm.block_sparse_dx_plain(g, w, ridx, rcnt, 32, 32)
    for plan in ((16, 64, 1), (128, 64, 1), (128, 64, 3), (128, 128, 2)):
        torch.full((96, 256), float("nan"), device=dev, dtype=dtype)  # freed at once
        got = tbsm.block_sparse_dx(g, w, ridx, rcnt, bm=16, bn=32, bk=32, plan=plan)
        assert bool(torch.isfinite(got.float()).all()), plan
        assert not got[:, :32].float().any() and not got[:, 96:128].float().any(), plan
        absp = tbsm.block_sparse_dx_plain(g.float().abs(), w.float().abs(), ridx, rcnt, 32, 32)
        _assert_within(got, want, absp, 384)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_dx_dead_expert_gives_zeros(dtype):
    """K5 on a bank whose groups 1 and 3 have no block (every count 0):
    exact zeros in their dx under every tile, split or not, the live groups
    within the bound of the plain version."""
    dev = _cuda()
    shape = (5, 96, 64, 96, 16, 16, (1, 3))
    g, w, ridx, rcnt, _, _ = _bs_dx_problem(shape, dtype, dev)
    want = tbsm.grouped_block_sparse_dx_plain(g, w, ridx, rcnt, 16, 16)
    absp = tbsm.grouped_block_sparse_dx_plain(g.float().abs(), w.float().abs(), ridx, rcnt,
                                              16, 16)
    for plan in ((16, 64, 1), (128, 64, 1), (128, 64, 2), (128, 128, 3)):
        got = tbsm.grouped_block_sparse_dx(g, w, ridx, rcnt, bm=16, bn=16, bk=16, plan=plan)
        for grp in shape[-1]:
            assert not got[grp].float().any(), (plan, grp)
        _assert_within(got, want, absp, 96)


@pytest.mark.cuda
def test_cuda_bs_dx_f32_keeps_f32_digits():
    """3xTF32 keeps f32's digits in K2 and K5: on danube's MLP wi shape (w
    2560 x 6912, density 0.26, dx of 2048 rows) and on a bank of 8 (w 2048
    x 1408, 256 rows), each unsplit and split in 2 and 4, the kernel's RMS
    error against a float64 product on the pack's blocks is at most 8x the
    plain f32 version's (one-pass TF32 would be ~1000x)."""
    from repro_torch.core.pack import pack_group_mask_rows

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(59)
    for G, M, K, N in ((1, 2048, 2560, 6912), (8, 256, 2048, 1408)):
        bm = torch.rand(G, K // 128, N // 128, device=dev, generator=gen) < 0.26
        live = bm.repeat_interleave(128, 1).repeat_interleave(128, 2)
        g = torch.randn(G, M, N, device=dev, generator=gen)
        w = torch.randn(G, K, N, device=dev, generator=gen) / N ** 0.5 * live
        ridx, rcnt = (torch.from_numpy(a).to(dev)
                      for a in pack_group_mask_rows(bm.cpu().numpy()))
        if G == 1:
            g, w, ridx, rcnt, live = g[0], w[0], ridx[0], rcnt[0], live[0]
        ref = torch.matmul(g.double(), torch.where(live, w.double(), 0.0).transpose(-1, -2))
        rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
        base = rms(_bs_dx_plain(g, w, ridx, rcnt, 128, 128))
        for n_split in (1, 2, 4):
            got = rms(_bs_dx(g, w, ridx, rcnt, 128, 128, (128, 128, n_split),
                             live=int(bm.sum())))
            assert got <= 8 * base, (G, M, n_split, got, base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bs_dx_nonfinite_g_reaches_only_the_blocks_that_read_it(dtype):
    """An inf in g (row 9) inside an active N-block that some K-block rows
    do not read, and a NaN in g's columns of an N-block no row reads (an
    empty block column of w): K2 and K5, split and unsplit, leave every
    dx element the plain version leaves finite finite (nothing reads an
    inactive block, nothing multiplies its zero); in f32 they give the
    plain version's +-inf and NaN in exactly its places: 3xTF32 walks such
    a tile again with the exact split."""
    from repro_torch.core.pack import pack_group_mask_rows

    dev = _cuda()
    g, w, _, _, live, _ = _bs_dx_problem((1, 48, 128, 256, 32, 32, ()), dtype, dev)
    bm = live[::32, ::32].clone()
    bm[:, 1] = False  # N-block 1: no K-block row reads it
    w[:, 32:64] = 0
    ridx, rcnt = (torch.from_numpy(a[0]).to(dev)
                  for a in pack_group_mask_rows(bm[None].cpu().numpy()))
    nb = int((bm.any(0) & (bm.sum(0) < bm.shape[0])).nonzero().flatten()[0])
    g[9, nb * 32 + 5] = float("inf")
    g[20, 32 + 3] = float("nan")
    plain = tbsm.block_sparse_dx_plain(g, w, ridx, rcnt, 32, 32)
    assert bool(torch.isinf(plain[9]).any()) and bool(torch.isfinite(plain[20]).all())
    assert bool(torch.isfinite(plain[9][~bm[:, nb].repeat_interleave(32)]).all())
    for plan in ((16, 64, 1), (16, 64, 3), (128, 64, 1), (128, 128, 2)):
        for got in (tbsm.block_sparse_dx(g, w, ridx, rcnt, bm=16, bn=32, bk=32, plan=plan),
                    tbsm.grouped_block_sparse_dx(g[None], w[None], ridx[None], rcnt[None],
                                                 bm=16, bn=32, bk=32, plan=plan)[0]):
            assert torch.equal(torch.isfinite(got), torch.isfinite(plain)), plan
            if dtype == torch.float32:
                assert torch.equal(torch.isnan(got), torch.isnan(plain)), plan
                inf = torch.isinf(plain)
                assert torch.equal(got[inf], plain[inf]), plan


@pytest.mark.cuda
def test_cuda_bs_dx_has_no_spill():
    """No instantiation of K2/K5's kernel spills a register (read back from
    the runtime), each holds at least as many CTAs an SM as the masked
    dgrad's on the same tile (no mask stage), and its shared bytes are a
    ring of at least two RowsA and n-major B stages plus the id list.  A
    plan that is not built, or splits past FWD_MAX_SPLIT, raises."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        e = torch.finfo(dtype).bits // 8
        for bm, bn in tmm.FWD_TILES:
            info = tbsm.dx_launch_info(dtype, bm, bn, 54)
            masked = tmm.fwd_launch_info(dtype, bm, bn, "dx")
            assert info["spill_bytes"] == 0 and info["registers"] <= 255, (dtype, bm, bn, info)
            assert info["ctas_per_sm"] >= masked["ctas_per_sm"], (dtype, bm, bn, info, masked)
            stage = (bm + bn) * (32 + 16 // e) * e
            ring = info["smem_bytes"] - 4 * 56
            assert ring % stage == 0 and ring >= 2 * stage, (dtype, bm, bn, info)
        g = torch.zeros(16, 256, device=dev, dtype=dtype)
        w = torch.zeros(256, 256, device=dev, dtype=dtype)
        ridx = torch.zeros(2, 2, dtype=torch.int32, device=dev)
        rcnt = torch.ones(2, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_dx(g, w, ridx, rcnt, bm=16, bn=128, bk=128, plan=(64, 64, 1))
        with pytest.raises(ValueError, match="built tile"):
            tbsm.block_sparse_dx(g, w, ridx, rcnt, bm=16, bn=128, bk=128,
                                 plan=(16, 64, tmm.FWD_MAX_SPLIT + 1))


@pytest.mark.cuda
def test_cuda_masked_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor the masked kernels do not take raises (f16, mixed
    dtypes, a non-bool mask, K not a multiple of 16); nothing falls back to
    the plain version."""
    dev = _cuda()
    x = torch.zeros(16, 64, device=dev, dtype=torch.float16)
    w = torch.zeros(64, 64, device=dev, dtype=torch.float16)
    m = torch.ones(64, 64, device=dev, dtype=torch.bool)
    n = [tmm.launches, tmm.dx_launches, tmm.dw_launches, tmm.gdw_launches,
         tmm.fused_launches, tmm.dw_merge_launches]
    with pytest.raises(TypeError, match="bf16 or f32"):
        masked_linear(x, w, m, block=(16, 16, 16))
    with pytest.raises(TypeError, match="bf16 or f32"):
        tmm.masked_dx(x.float(), w.bfloat16(), m, bm=16, bk=16)
    with pytest.raises(TypeError, match="bool"):
        tmm.masked_dw(x.float(), x.float(), m.float(), bn=16, bk=16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tmm.masked_matmul(torch.zeros(16, 40, device=dev), torch.zeros(40, 64, device=dev),
                          torch.ones(40, 64, device=dev, dtype=torch.bool), bm=16, bn=16)
    with pytest.raises(TypeError, match="mom"):
        tmm.masked_dw_fused(x.float(), x.float(), m, w.float(), w.double(), 0, mu=0.9,
                            wd=0.0, sr=False, bn=16, bk=16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tmm.grouped_masked_dw(x[None], x[None], m[None], bn=16, bk=16)
    # a split past the 16 rows' one slab, a tile that is not built
    with pytest.raises(ValueError, match="plan"):
        tmm.masked_dw(x.float(), x.float(), m, bn=16, bk=16, plan=(128, 128, 2))
    with pytest.raises(ValueError, match="plan"):
        tmm.grouped_masked_dw(x[None].float(), x[None].float(), m[None], bn=16, bk=16,
                              plan=(64, 64, 1))
    assert [tmm.launches, tmm.dx_launches, tmm.dw_launches, tmm.gdw_launches,
            tmm.fused_launches, tmm.dw_merge_launches] == n


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_masked_training_step_runs_the_kernels(fused):
    """A danube SMOKE train step under kernel='masked' (RigL with the
    superset carrier; bf16 attention, f32 MLP) on the card launches K13,
    K14 and K15 with K15's planned split merges, or with the fused SGD
    epilogue (bf16 state, sr) K13, K14 and K19 with K19's planned split
    merges and no K15 or dw merge; it agrees with the same step on the CPU
    (plain versions) within bf16 tolerance."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps

    dev = _cuda()
    cfg = dataclasses.replace(
        get_config("h2o-danube-1.8b", smoke=True),
        sparse=SparseConfig(sparsity=0.8, kernel="masked", kernel_block=(128, 16, 16),
                            attn_kernel="flash_tight", fused_epilogue=fused))
    opt = (OptConfig(kind="sgd", momentum=0.9, weight_decay=1e-4, state_dtype="bfloat16")
           if fused else OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0))
    lr = LRSchedule(kind="constant", base_lr=1e-3, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 32)))
    batch = {"tokens": toks, "targets": (toks * 3 + 7) % 128}
    read = lambda: [tmm.launches, tmm.dx_launches, tmm.dw_launches, tmm.fused_launches,
                    tmm.dw_merge_launches, tmm.dw_fused_merge_launches]
    losses, states = [], []
    for device in ("cpu", dev):
        st, _ = steps.init_train_state(cfg, opt, seed=0, device="cpu")
        st = {k: _to(v, device) for k, v in st.items()}
        before = read()
        st, m = steps.make_train_step(cfg, opt, lr)(
            st, {k: v.to(device) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        states.append(st)
        after = read()
    n_proj = 7 * cfg.n_layers
    delta = [b - a for a, b in zip(before, after)]
    merges = cfg.n_layers * _dw_merges(cfg, st["params"]["layers"][0], 64, dev,
                                       "dw_fused" if fused else "dw")
    assert delta == ([n_proj, n_proj, 0, n_proj, 0, merges] if fused
                     else [n_proj, n_proj, n_proj, 0, merges, 0])
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[0])
    if fused:
        assert all(t.dtype == torch.bfloat16 for t in _leaves(st["opt"]["momentum"]))
        _fused_state_agrees(states[0], st, lr.base_lr)


def _dw_merges(cfg, layer, tokens, dev, entry="dw"):
    """K15's (``entry`` "dw") or K19's ("dw_fused") split merges of one
    layer's 7 projections at ``tokens`` rows (the wgrad's plan: rows K,
    contraction the padded rows, columns N; the attention in the compute
    dtype, the MLP in f32, as the model calls them)."""
    from repro_torch.kernels.ops import _row_tile
    from repro_torch.models.layers import compute_dtype

    _, Mp = _row_tile(tokens, cfg.sparse.kernel_block[0])
    shapes = ([(layer["attn"][n]["w"].shape, compute_dtype(cfg)) for n in ("wq", "wk", "wv", "wo")]
              + [(layer["mlp"][n]["w"].shape, torch.float32) for n in ("wi", "wg", "wo")])
    bn = cfg.sparse.kernel_block[1]
    return sum(tmm._fwd_plan_for(K, Mp, N, 1, dt, bn, dev.index or 0, entry)[2] > 1
               for (K, N), dt in shapes)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)


def _pairs(a, b, path=""):
    """(path, a leaf, b leaf) over two trees of one structure."""
    if torch.is_tensor(a):
        yield path, a, b
    elif isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (u, v) in enumerate(zip(a, b)):
            yield from _pairs(u, v, f"{path}/{i}")


def _fused_state_agrees(cpu, card, lr):
    """The card step's new momentum and params against the CPU step's
    (plain versions), leaf by leaf: the momentum within the reference's
    bf16 bound, 2e-2 of the leaf's largest CPU entry
    (tests/test_fused_epilogue.py), the params within lr times that plus
    two f32 roundings of the leaf's largest param (p - lr * m is rounded
    once on each side)."""
    eps = torch.finfo(torch.float32).eps
    params = {n: (a, b) for n, a, b in _pairs(cpu["params"], card["params"])}
    n_mom = 0
    for n, a, b in _pairs(cpu["opt"]["momentum"], card["opt"]["momentum"]):
        a, b = a.float(), b.float().cpu()
        mref = a.abs().max().item()
        assert (a - b).abs().max().item() <= 2e-2 * mref, f"momentum {n}"
        pa, pb = (t.float().cpu() for t in params[n])
        tol = lr * 2e-2 * mref + 2 * eps * pa.abs().max().item()
        assert (pa - pb).abs().max().item() <= tol, f"params {n}"
        n_mom += 1
    assert n_mom == len(params)


def _pin_routing(monkeypatch):
    """Route the second run as the first: the CPU run records every
    ``models/moe.py::route`` call's top-k ids, the card run takes them (its
    gates renormalised over the same experts, as ``route`` does), so a
    router near tie cannot move a token between experts.  Returns a
    callable that switches from recording to forcing."""
    from repro_torch.models import moe as moe_mod

    real, picks, forced = moe_mod.route, [], []

    def route(p, xt, cfg):
        probs, gates, eidx = real(p, xt, cfg)
        if forced:
            eidx = forced[0].pop(0).to(eidx.device)
            gates = probs.gather(1, eidx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        else:
            picks.append(eidx.cpu())
        return probs, gates, eidx

    monkeypatch.setattr(moe_mod, "route", route)
    return lambda: forced.append(picks)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,softcap", [(16, 0.0), (128, 0.0), (16, 30.0)])
def test_cuda_paged_flash_matches_plain(Sq, softcap):
    """K12 at mistral-large's attention widths (96 heads over 8 KV heads,
    head_dim 128) on 256 pages of 16 per row, ctx 0, 100 (inside a page),
    2047 and 4096 with sentinel table tails: o element by element within
    ``o_error_bound``, lse within 1e-3 and exactly -1e30 (o = 0) where
    ctx = 0."""
    dev = _cuda()
    B, H, KV, d, bs, T, N = 4, 96, 8, 128, 16, 256, 1024
    rng = np.random.default_rng(Sq)
    ctxs = [0, 100, 2047, 4096]
    table = np.full((B, T), N, np.int32)
    perm = rng.permutation(N)
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        table[b, :n], perm = perm[:n], perm[n:]
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).to(dev)
    q, pk, pv = f(B, H, Sq, d), f(N, bs, KV, d), f(N, bs, KV, d)
    table = torch.from_numpy(table).to(dev)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    n0 = tfa.paged_launches
    o, lse = tfa.flash_attention_paged(q, pk, pv, table, ctx, softcap=softcap)
    assert tfa.paged_launches == n0 + 1
    po, plse = tfa.flash_attention_paged_plain(q, pk, pv, table, ctx, softcap=softcap)
    pa, _ = tfa.flash_attention_paged_plain(q, pk, pv.abs(), table, ctx, softcap=softcap)
    assert bool(((o.float() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    live = plse > -1e29
    assert (lse[live] - plse[live]).abs().max().item() <= 1e-3
    assert bool((lse[0] == -1e30).all()) and bool((o[0] == 0).all())
    assert int((~live).sum()) == H * Sq


def _paged_path_problem(dev, seed=37):
    """The paged-serve path's K12 shape: one 16-row suffix of mistral-large
    (96 heads over 8 KV heads, head_dim 128) over a 37-page table of 16
    keys in a pool of 148 shuffled pages, ctx 512 (the last 5 entries are
    the sentinel)."""
    B, H, KV, d, bs, T, N = 1, 96, 8, 128, 16, 37, 148
    rng = np.random.default_rng(seed)
    table = np.full((B, T), N, np.int32)
    table[0, :32] = rng.permutation(N)[:32]
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).to(dev)
    return (f(B, H, 16, d), f(N, bs, KV, d), f(N, bs, KV, d),
            torch.from_numpy(table).to(dev), torch.tensor([512], dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_cuda_paged_flash_split_matches_plain():
    """K12 at the paged-serve path's shape splits its key walk (n_split > 1
    on the card's SM count) and agrees with the plain version: o element by
    element within ``o_error_bound``, lse within 1e-3; one launch counted."""
    dev = _cuda()
    q, pk, pv, table, ctx = _paged_path_problem(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, _ = tfa.paged_split_plan(1, 8, 12 * 16, table.shape[1], 16, n_sm)
    assert n_split > 1
    n0 = tfa.paged_launches
    o, lse = tfa.flash_attention_paged(q, pk, pv, table, ctx)
    assert tfa.paged_launches == n0 + 1
    po, plse = tfa.flash_attention_paged_plain(q, pk, pv, table, ctx)
    pa, _ = tfa.flash_attention_paged_plain(q, pk, pv.abs(), table, ctx)
    assert bool(((o.float() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse - plse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_flash_kernels_are_deterministic():
    """Two launches of K9, K10 and K11 (danube's d = 80, G = 4, window;
    qwen2-moe's d = 128, G = 1, causal; at these sizes both backward kernels
    split their walks, and pair their units at qwen2-moe's) and of K12
    (split and unsplit) on the same inputs give identical bits."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    for BH, G, d, S, window in ((8, 4, 80, 700, 256), (4, 1, 128, 600, 0)):
        q, k, v = (torch.from_numpy(rng.standard_normal((n, S, d)).astype(np.float32))
                   .to(torch.bfloat16).to(dev) for n in (BH, BH // G, BH // G))
        kw = dict(causal=True, window=window, kv_groups=G, return_lse=True)
        a, b = (tfa.flash_attention(q, k, v, **kw) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        do = torch.randn_like(q)
        o, lse = tfa.flash_attention(q, k, v, **kw)
        bq, bk = tfa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - S))
        sched = tfa._schedule_on(dev, S, S, bq, bk, True, window, 0)
        bkw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                   scale=d ** -0.5, softcap=0.0, kv_groups=G)
        args = (pad(q), pad(k), pad(v), pad(do), pad(lse[..., None])[..., 0].contiguous())
        delta = (args[3].float() * pad(o).float()).sum(-1)
        a, b = (tfa.flash_dq(*args, delta, sched[0], sched[1], **bkw) for _ in range(2))
        assert torch.equal(a, b)
        a, b = (tfa.flash_dkv(*args, delta, sched[2], sched[3], **bkw) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    q, pk, pv, table, ctx = _paged_path_problem(dev)
    for qq in (q, q.repeat(4, 1, 8, 1)):  # split, then Sq 128 x 4 rows: unsplit
        tt, cc = table.repeat(qq.shape[0], 1), ctx.repeat(qq.shape[0])
        a, b = (tfa.flash_attention_paged(qq, pk, pv, tt, cc) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 592])
def test_cuda_flash_d128_g12_matches_plain(S):
    """K9 at mistral-large's head_dim 128 and 12 query heads per KV head:
    the paged-serve path's full prefill (592) and suffix self phase (16)."""
    dev = _cuda()
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, S, 128)).astype(np.float32))
               .to(torch.bfloat16) for n in (24, 2, 2))
    kw = dict(causal=True, window=0, kv_groups=12, return_lse=True)
    o, lse = tfa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    po, plse = tfa.flash_attention(q, k, v, **kw)
    pa, _ = tfa.flash_attention(q, k, v.abs(), **kw)
    assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse.cpu() - plse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_paged_flash_raises_instead_of_falling_back():
    dev = _cuda()
    q = torch.zeros(1, 4, 8, 64, device=dev)
    pool = torch.zeros(4, 16, 2, 64, device=dev)
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    ctx = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_attention_paged(q, pool, pool, table, ctx)
    qb, pb = q.bfloat16(), pool.bfloat16()
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_attention_paged(qb, pb, pb, table.long(), ctx)
    with pytest.raises(ValueError, match="on cpu"):
        tfa.flash_attention_paged(qb, pb, pb, table.cpu(), ctx)


@pytest.mark.cuda
def test_cuda_prefix_engine_runs_k12():
    """The paged engine with the prefix cache on mistral-large SMOKE
    (block_sparse, block 16, flash_tight, bf16) on the card: one miss then
    hits, each suffix prefill one K12 launch per layer, clean pool books."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.launch.serve import init_serving_state
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Request, Status

    dev = _cuda()
    cfg = dataclasses.replace(
        get_config("mistral-large-123b", smoke=True),
        sparse=SparseConfig(sparsity=0.8, kernel="block_sparse", block_shape=(16, 16),
                            kernel_block=(128, 16, 16), attn_kernel="flash_tight"))
    params, masks, pack = init_serving_state(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, capacity=2, max_len=64, masks=masks, pack=pack,
                      paged=True, page_size=16, prefix_cache=2)
    rng = np.random.default_rng(0)
    tmpl = rng.integers(0, 128, 32)
    reqs = [Request(rid=i, tokens=np.concatenate([tmpl, rng.integers(0, 128, 3 + i)]),
                    max_new_tokens=5, share_prefix_len=32, temperature=0.8 * (i % 2),
                    top_k=10, seed=i) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    n0 = tfa.paged_launches
    while len(eng.queue) or eng.active.any():
        eng.step(now=0.0)
    assert all(r.status is Status.DONE and len(r.generated) == 5 for r in reqs)
    assert (eng.n_prefix_misses, eng.n_prefix_hits) == (1, 3)
    assert tfa.paged_launches - n0 == 3 * cfg.n_layers
    eng.check_pool_accounting()


# (G, M, K, N, blk, dead experts): a small bank with dead experts, and the
# qwen2-moe-a2.7b banks wi/wg (2048 -> 1408) and wo (1408 -> 2048) at a
# capacity-4 decode step's 16 padded rows
GROUPED_SHAPES = [(5, 5, 64, 96, 16, (1, 3)), (60, 16, 2048, 1408, 128, (7,)),
                  (60, 16, 1408, 2048, 128, ())]


def _grouped_problem(shape, seed=9, density=0.2):
    G, M, K, N, blk, dead = shape
    rng = np.random.default_rng(seed)
    bm = rng.random((G, K // blk, N // blk)) < density
    bm[:, :, 0] = False  # an empty column in every expert
    for g in dead:
        bm[g] = False
    dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 1), blk, 2))
    w = torch.randn(G, K, N) / K ** 0.5 * dense
    return torch.randn(G, M, K), w, dense


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_cuda_grouped_block_sparse_matches_plain(shape, dtype):
    """K4 against its plain version on the card, element by element within
    ``matmul_error_bound`` (bf16 also within one ulp of the largest
    output); dead experts and empty columns come out zero; one launch."""
    from repro_torch.core.pack import pack_entry
    from repro_torch.kernels.ops import grouped_block_sparse_linear

    dev = _cuda()
    dt = getattr(torch, dtype)
    G, M, K, N, blk, dead = shape
    x, w, dense = _grouped_problem(shape)
    x, w = x.to(dev, dt), w.to(dev, dt)
    e = pack_entry(dense, (blk, blk), device=dev)
    n0 = tbsm.g_launches
    got = grouped_block_sparse_linear(x, w, pack=e, block=(128, blk, blk))
    assert tbsm.g_launches == n0 + 1
    Mp = -(-M // 16) * 16
    xp = torch.nn.functional.pad(x, (0, 0, 0, Mp - M))
    want = tbsm.grouped_block_sparse_matmul_plain(xp, w, e["idx"], e["cnt"], blk, blk)[:, :M]
    absp = tbsm.grouped_block_sparse_matmul_plain(xp.abs().float(), w.abs().float(),
                                                  e["idx"], e["cnt"], blk, blk)[:, :M]
    bound = tbsm.matmul_error_bound(want, absp, K)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    if dt == torch.bfloat16:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()
    assert not got[:, :, :blk].float().any()
    for g in dead:
        assert not got[g].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_cuda_grouped_masked_matches_plain(shape, dtype):
    """K16 against its plain version on an elementwise mask (density 0.12,
    dead experts fully masked), element by element within
    ``matmul_error_bound``; one launch."""
    from repro_torch.kernels.ops import grouped_masked_linear

    dev = _cuda()
    dt = getattr(torch, dtype)
    G, M, K, N, blk, dead = shape
    x = torch.randn(G, M, K, device=dev).to(dt)
    w = (torch.randn(G, K, N, device=dev) / K ** 0.5).to(dt)
    m = torch.rand(G, K, N, device=dev) < 0.12
    for g in dead:
        m[g] = False
    n0 = tmm.g_launches
    got = grouped_masked_linear(x, w, m, block=(128, blk, blk))
    assert tmm.g_launches == n0 + 1
    want = tmm.grouped_masked_matmul_plain(x, w, m)
    absp = tmm.grouped_masked_matmul_plain(x.abs().float(), w.abs().float(), m)
    bound = tmm.matmul_error_bound(want, absp, K)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    for g in dead:
        assert not got[g].float().any()


@pytest.mark.cuda
def test_cuda_grouped_wrappers_raise_instead_of_falling_back():
    dev = _cuda()
    x = torch.zeros(2, 16, 32, device=dev, dtype=torch.float16)
    w = torch.zeros(2, 32, 32, device=dev, dtype=torch.float16)
    idx = torch.zeros(2, 2, 1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tbsm.grouped_block_sparse_matmul(x, w, idx, cnt, bm=16, bn=16, bk=16)
    xf, wf = x.float(), w.float()
    with pytest.raises(ValueError, match="does not match"):
        tbsm.grouped_block_sparse_matmul(xf, wf, idx[:1], cnt[:1], bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="on cpu"):
        tbsm.grouped_block_sparse_matmul(xf, wf, idx.cpu(), cnt.cpu(), bm=16, bn=16, bk=16)
    m = torch.ones(2, 32, 32, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tmm.grouped_masked_matmul(x, w, m, bm=16, bn=16)
    with pytest.raises(TypeError, match="bool"):
        tmm.grouped_masked_matmul(xf, wf, m.float(), bm=16, bn=16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 1000])
def test_cuda_flash_d128_g1_matches_plain(S):
    """K9 at qwen2-moe-a2.7b's attention: 16 query heads over 16 KV heads
    (G = 1), head_dim 128, a 100- and a 1000-token prefill."""
    dev = _cuda()
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((16, S, 128)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, window=0, kv_groups=1, return_lse=True)
    o, lse = tfa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    po, plse = tfa.flash_attention(q, k, v, **kw)
    pa, _ = tfa.flash_attention(q, k, v.abs(), **kw)
    assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse.cpu() - plse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_moe_engine_runs_grouped_kernels(kernel):
    """qwen2-moe SMOKE served on the card (block 16, flash_tight): every
    request DONE, and each decode step launches the grouped kernel once per
    bank and layer (3 x n_layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel, init_serving_state
    from repro_torch.launch.serve import staggered_requests
    from repro_torch.models.model import lm_decode
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    dev = _cuda()
    cfg = configure_kernel(get_config("qwen2-moe-a2.7b", smoke=True), kernel=kernel,
                           block=16 if kernel == "block_sparse" else None,
                           attn_kernel="flash_tight")
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel_block=(128, 16, 16)))
    params, masks, pack = init_serving_state(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack)
    reqs = staggered_requests(cfg, 3, prompt_lens=(5, 11), gen_lens=(4, 6))
    for r in reqs:
        eng.submit(r)
    while len(eng.queue) or eng.active.any():
        eng.step(now=0.0)
    assert all(r.status is Status.DONE for r in reqs)
    mod = tbsm if kernel == "block_sparse" else tmm
    n0 = mod.g_launches
    tok = torch.zeros(2, 1, dtype=torch.long, device=dev)
    lm_decode(eng.params, cfg, eng.caches, tok, 20, masks=masks, pack=pack)
    assert mod.g_launches - n0 == 3 * cfg.n_layers


# (G, M, K, N, blk, dead experts) of the grouped backward: a small bank with
# dead experts, and the qwen2-moe-a2.7b banks wi/wg and wo at a 2048-token
# training microbatch's capacity (C = 171 rows, padded to the 128-row tile)
GROUPED_BWD_SHAPES = [(5, 32, 64, 96, 16, (1, 3)), (60, 256, 2048, 1408, 128, (7,)),
                      (60, 256, 1408, 2048, 128, ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", GROUPED_BWD_SHAPES)
def test_cuda_grouped_block_sparse_bwd_matches_plain(shape, dtype):
    """K5 (dx on the stacked CSR) and K6 (dw on a stacked superset CSC with
    its own, wider shared width) against their plain versions, element by
    element within ``matmul_error_bound``; dead experts give zero dx rows
    and a zero dw, dw is zero outside the superset; one launch each."""
    from repro_torch.core.pack import pack_entry

    dev = _cuda()
    dt = getattr(torch, dtype)
    G, M, K, N, blk, dead = shape
    x, w, dense = _grouped_problem(shape)
    sup = dense | (torch.rand(dense.shape[0], K // blk, N // blk) < 0.1).repeat_interleave(
        blk, 1).repeat_interleave(blk, 2)
    sup[:, :, :blk] = True  # the superset fills the forward's empty column
    for g in dead:
        sup[g] = False
    e = pack_entry(dense, (blk, blk), device=dev, bwd_mask=sup)
    assert e["bidx"].shape[-1] > e["idx"].shape[-1]
    x, w = x.to(dev, dt), w.to(dev, dt)
    g_ = torch.randn(G, M, N, device=dev).to(dt)
    xr = torch.randn(G, M, K, device=dev).to(dt)
    n0, m0 = tbsm.gdx_launches, tbsm.gdw_launches
    dx = tbsm.grouped_block_sparse_dx(g_, w, e["ridx"], e["rcnt"], bm=min(128, M), bn=blk,
                                      bk=blk)
    dw = tbsm.grouped_block_sparse_dw(xr, g_, e["bidx"], e["bcnt"], bn=blk, bk=blk)
    assert (tbsm.gdx_launches, tbsm.gdw_launches) == (n0 + 1, m0 + 1)
    for got, want, absp, n in (
            (dx, tbsm.grouped_block_sparse_dx_plain(g_, w, e["ridx"], e["rcnt"], blk, blk),
             tbsm.grouped_block_sparse_dx_plain(g_.abs().float(), w.abs().float(),
                                                e["ridx"], e["rcnt"], blk, blk), N),
            (dw, tbsm.grouped_block_sparse_dw_plain(xr, g_, e["bidx"], e["bcnt"], blk, blk),
             tbsm.grouped_block_sparse_dw_plain(xr.abs().float(), g_.abs().float(),
                                                e["bidx"], e["bcnt"], blk, blk), M)):
        assert got.dtype == dt
        bound = tbsm.matmul_error_bound(want, absp, n)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    for g in dead:
        assert not dx[g].float().any() and not dw[g].float().any()
    assert not dw[~sup.to(dev)].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", GROUPED_BWD_SHAPES)
def test_cuda_grouped_masked_bwd_matches_plain(shape, dtype):
    """K17 (dx on the forward mask) and K18 (dw masked at the store by a
    superset) against their plain versions on elementwise masks (density
    0.12, dead experts fully masked), within ``matmul_error_bound``."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    G, M, K, N, blk, dead = shape
    g_ = torch.randn(G, M, N, device=dev).to(dt)
    x = torch.randn(G, M, K, device=dev).to(dt)
    w = (torch.randn(G, K, N, device=dev) / K ** 0.5).to(dt)
    m = torch.rand(G, K, N, device=dev) < 0.12
    b = m | (torch.rand(G, K, N, device=dev) < 0.05)
    for g in dead:
        m[g] = b[g] = False
    n0, m0 = tmm.gdx_launches, tmm.gdw_launches
    dx = tmm.grouped_masked_dx(g_, w, m, bm=min(128, M), bk=blk)
    dw = tmm.grouped_masked_dw(x, g_, b, bn=blk, bk=blk)
    assert (tmm.gdx_launches, tmm.gdw_launches) == (n0 + 1, m0 + 1)
    for got, want, absp, n in (
            (dx, tmm.grouped_masked_dx_plain(g_, w, m),
             tmm.grouped_masked_dx_plain(g_.abs().float(), w.abs().float(), m), N),
            (dw, tmm.grouped_masked_dw_plain(x, g_, b),
             tmm.grouped_masked_dw_plain(x.abs().float(), g_.abs().float(), b), M)):
        bound = tmm.matmul_error_bound(want, absp, n)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    for g in dead:
        assert not dx[g].float().any() and not dw[g].float().any()
    assert not dw[~b].float().any()


@pytest.mark.cuda
def test_cuda_grouped_bwd_wrappers_raise_instead_of_falling_back():
    dev = _cuda()
    g = torch.zeros(2, 16, 32, device=dev)
    w = torch.zeros(2, 32, 32, device=dev)
    r = torch.zeros(2, 2, 1, dtype=torch.int32, device=dev)
    c = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tbsm.grouped_block_sparse_dx(g.half(), w.half(), r, c, bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="does not match"):
        tbsm.grouped_block_sparse_dx(g, w, r[:1], c[:1], bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="on cpu"):
        tbsm.grouped_block_sparse_dw(g, g, r.cpu(), c.cpu(), bn=16, bk=16)
    m = torch.ones(2, 32, 32, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="bool"):
        tmm.grouped_masked_dx(g, w, m.float(), bm=16, bk=16)
    with pytest.raises(ValueError, match="3-D"):
        tmm.grouped_masked_dw(g[0], g[0], m[0], bn=16, bk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 1024])
def test_cuda_flash_backward_d128_g1_matches_plain(S):
    """K10 (dq) and K11 (dk, dv) at qwen2-moe-a2.7b's attention (16 query
    heads over 16 KV heads, G = 1, head_dim 128, causal): the training
    microbatch's S = 1024 and a ragged S = 100, element by element within
    ``grad_error_bound``."""
    dev = _cuda()
    rng = np.random.default_rng(S + 1)
    r = lambda: torch.from_numpy(rng.standard_normal((16, S, 128)).astype(np.float32)).to(
        torch.bfloat16)
    q, k, v, do = r(), r(), r(), r()
    bq, bk = tfa.effective_blocks(S, S)
    Sp = -(-S // bq) * bq
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - S))
    q, k, v, do = pad(q), pad(k), pad(v), pad(do)
    sched = tfa._schedule_on(torch.device("cpu"), S, S, bq, bk, True, 0, 0)
    kw = dict(bq=bq, bk=bk, causal=True, window=0, q_offset=0, sk=S,
              scale=128 ** -0.5, softcap=0.0, kv_groups=1)
    o, lse = tfa.flash_fwd(q, k, v, sched[0], sched[1], **kw)
    delta = (do.float() * o.float()).sum(-1)
    blocks = tfa._schedule_mask(sched[0], sched[1], Sp // bk, "cpu")
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


def _bwd_problem(seed, BH, G, d, Sq, Sk, causal, window, softcap, blocks=None):
    """bf16 q, k, v, do on the padded layout (CPU), the plain forward's lse
    and delta, the schedule (CPU) and the kernels' keyword arguments."""
    from repro_torch.core.attn_sched import sched_for

    rng = np.random.default_rng(seed)
    bq, bk = blocks or tfa.effective_blocks(Sq, Sk)
    Sqp, Skp = -(-Sq // bq) * bq, -(-Sk // bk) * bk
    r = lambda n, s, sp: torch.nn.functional.pad(torch.from_numpy(
        rng.standard_normal((n, s, d)).astype(np.float32)).to(torch.bfloat16), (0, 0, 0, sp - s))
    q, k, v, do = r(BH, Sq, Sqp), r(BH // G, Sk, Skp), r(BH // G, Sk, Skp), r(BH, Sq, Sqp)
    s = sched_for(Sq, Sk, bq, bk, causal, window, Sk - Sq)
    sched = [torch.from_numpy(s[n]) for n in ("kv_idx", "kv_cnt", "q_idx", "q_cnt")]
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=Sk - Sq, sk=Sk,
              scale=d ** -0.5, softcap=softcap, kv_groups=G)
    o, lse = tfa.flash_fwd(q, k, v, sched[0], sched[1], **kw)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta), sched, kw


# (BH, G, d, Sq, Sk, causal, window, softcap, (bq, bk) or None): the edges
# of K10/K11's 64-row units and walks
BWD_EDGES = {
    # S not a multiple of 64: the last units are partly padding
    "S=200 G=4 d=80": (8, 4, 80, 200, 200, True, 0, 0.0, None),
    # windows 100 and 150: edges inside 64-key tiles
    "window 100 S=400": (8, 4, 80, 400, 400, True, 100, 0.0, None),
    "window 150 d=128 G=2": (4, 2, 128, 330, 330, True, 150, 0.0, None),
    # 64-row blocks: 5 units (odd), so one CTA of a pairing walks alone
    "blocks 64 S=320 (5 units)": (8, 4, 80, 320, 320, True, 0, 0.0, (64, 64)),
    # bq = bk = 112: a 64-row and a 48-row unit per block
    "S=100 bq=112": (8, 4, 80, 100, 100, True, 0, 0.0, None),
    "d=128 G=1 S=520": (4, 1, 128, 520, 520, True, 0, 0.0, None),
    "d=64 (generic instantiation)": (4, 2, 64, 300, 300, True, 0, 0.0, None),
    "softcap 30 G=4": (8, 4, 80, 260, 260, True, 0, 30.0, None),
    "q_offset Sq=77 Sk=300": (8, 4, 80, 77, 300, True, 0, 0.0, None),
    "dead rows Sq=90 Sk=40": (4, 2, 80, 90, 40, True, 0, 0.0, None),
    "no mask": (4, 2, 80, 200, 200, False, 0, 0.0, None),
    # d = 256: K10's 32-key tiles (a 112-key block is 32 + 32 + 32 + 16),
    # K11's warp pairs (a 48-row unit runs 3 of 4 pairs), the softcap's
    # 1 - t^2 handed over with p, dead rows
    "S=100 bq=112 d=256": (4, 2, 256, 100, 100, True, 0, 0.0, None),
    "softcap 30 d=256": (4, 2, 256, 260, 260, True, 0, 30.0, None),
    "dead rows d=256": (4, 2, 256, 90, 40, True, 0, 0.0, None),
    # hubert-xlarge's bidirectional attention (G = 1, d = 80) at a length
    # the 128-row blocks do not divide: every walk the same length, the
    # padded query rows see every real key; internvl2-1b's G = 7 at d = 64
    "bidirectional S=1000 d=80": (4, 1, 80, 1000, 1000, False, 0, 0.0, None),
    "G=7 d=64 S=300": (14, 7, 64, 300, 300, True, 0, 0.0, None),
    # grok-1-314b's softcap 30 at d = 128, G = 6 (48 heads over 8, cut to 2
    # KV heads), S not a multiple of 64
    "softcap 30 d=128 G=6": (12, 6, 128, 260, 260, True, 0, 30.0, None),
}


# (BH, G, d, S, causal): the frontend families' attention through the
# wrapper: hubert-xlarge's bidirectional 16 heads at a length the 128-row
# blocks do not divide, internvl2-1b's 14 heads over 2
FRONTEND_FLASH = {
    "hubert bidirectional S=1000": (16, 1, 80, 1000, False),
    "internvl G=7 S=600": (14, 7, 64, 600, True),
    "internvl G=7 bidirectional S=200": (14, 7, 64, 200, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FRONTEND_FLASH))
def test_cuda_flash_wrapper_frontend_shapes_match_plain(case):
    """``flash_attention`` on the card (K9, then K10 and K11 through
    autograd) at the frontend families' shapes: o within
    ``o_error_bound`` of the same wrapper on CPU tensors (the plain
    version), and the gradients of the S real rows within
    ``grad_error_bound`` of the plain backward on the padded layout with
    zero dO on the padded query rows, which the wrapper's trim gives them
    (otherwise dv takes p^T dO from rows that see every real key).  The
    plain backward takes the wrapper's forward: K9's o (for delta) and
    lse on the padded layout, as the kernels' checks do (the bound covers
    the backward's own roundings, not another forward's)."""
    dev = _cuda()
    BH, G, d, S, causal = FRONTEND_FLASH[case]
    rng = np.random.default_rng(len(case))
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
    q, do = bf(BH, S, d), bf(BH, S, d)
    k, v = bf(BH // G, S, d), bf(BH // G, S, d)
    kw = dict(causal=causal, window=0, kv_groups=G)
    leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do.to(dev))
    po, pa = tfa.flash_attention(q, k, v, **kw), tfa.flash_attention(q, k, v.abs(), **kw)
    assert bool(((o.detach().float().cpu() - po.float()).abs()
                 <= tfa.o_error_bound(po, pa)).all())
    bq, bk = tfa.effective_blocks(S, S)
    Sp = -(-S // bq) * bq
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - t.shape[1]))
    qp, kp, vp, dop = pad(q), pad(k), pad(v), pad(do)
    sched = tfa._schedule_on(torch.device("cpu"), S, S, bq, bk, causal, 0, 0)
    pkw = dict(bq=bq, bk=bk, causal=causal, window=0, q_offset=0, sk=S, scale=d ** -0.5,
               softcap=0.0, kv_groups=G)
    op, lse = (t.cpu() for t in tfa.flash_fwd(*(t.to(dev) for t in (qp, kp, vp, *sched[:2])),
                                              **pkw))
    delta = (dop.float() * op.float()).sum(-1)
    blocks = tfa._schedule_mask(sched[0], sched[1], Sp // bk, "cpu")
    *want, dq_a, dk_a, dv_a, dq_e, dk_e, dv_e = tfa.flash_bwd_plain(
        qp, kp, vp, dop, lse, delta, blocks, with_abs=True, **pkw)
    for name, g, w_, a, e in zip(("dq", "dk", "dv"), got, want, (dq_a, dk_a, dv_a),
                                 (dq_e, dk_e, dv_e)):
        diff = (g.float().cpu() - w_[:, :S].float()).abs()
        assert bool((diff <= tfa.grad_error_bound(w_, a, e)[:, :S]).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (False, 1), (True, 1), (False, 3), (True, 2)])
@pytest.mark.parametrize("case", sorted(BWD_EDGES))
def test_cuda_flash_backward_edges_match_plain(case, plan, monkeypatch):
    """K10 and K11 at the edges of their 64-row units and walks, under their
    own plan (``bwd_plan``) and with the plan forced (pairing on and off,
    walks split into 1-3 parts, unequal where the step count does not
    divide), element by element within ``grad_error_bound``; one launch
    each."""
    dev = _cuda()
    BH, G, d, Sq, Sk, causal, window, softcap, blocks = BWD_EDGES[case]
    args, sched, kw = _bwd_problem(len(case), BH, G, d, Sq, Sk, causal, window, softcap,
                                   blocks)
    if plan is not None:
        monkeypatch.setattr(tfa, "_bwd_plan_for", lambda *a, **k: plan)
    visible = tfa._schedule_mask(sched[0], sched[1], args[1].shape[1] // kw["bk"], "cpu")
    *want, dq_a, dk_a, dv_a, dq_e, dk_e, dv_e = tfa.flash_bwd_plain(
        *args, visible, with_abs=True, **kw)
    on = lambda *ts: [t.to(dev) for t in ts]
    n0 = (tfa.dq_launches, tfa.dkv_launches)
    dq = tfa.flash_dq(*on(*args, sched[0], sched[1]), **kw)
    dk, dv = tfa.flash_dkv(*on(*args, sched[2], sched[3]), **kw)
    assert (tfa.dq_launches, tfa.dkv_launches) == (n0[0] + 1, n0[1] + 1)
    for name, got, w_, a, e in (("dq", dq, want[0], dq_a, dq_e),
                                ("dk", dk, want[1], dk_a, dk_e),
                                ("dv", dv, want[2], dv_a, dv_e)):
        diff = (got.float().cpu() - w_.float()).abs()
        assert bool((diff <= tfa.grad_error_bound(w_, a, e)).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_cuda_flash_backward_has_no_spill(d):
    """K10 and K11 at hymba's d = 64, danube's d = 80, qwen2-moe's d = 128
    and gemma3's d = 256 spill no registers (a spill is a defect of the
    design) and get the warps and the CTAs per SM their design and the plan
    count on (``tfa.bwd_warps``: a 16-row warp a unit row group, a pair of
    them under K11 at d = 256; ``tfa.bwd_ctas_per_sm``)."""
    _cuda()
    for kind in ("dq", "dkv"):
        info = tfa.launch_info(f"flash_{kind}", d, 8)
        assert info["spill_bytes"] == 0, (kind, info)
        assert info["ctas_per_sm"] == tfa.bwd_ctas_per_sm(kind, d), (kind, info)
        assert info["warps"] == tfa.bwd_warps(kind, d), (kind, info)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_moe_training_step_runs_the_grouped_backward(kernel):
    """A qwen2-moe SMOKE train step on the card (RigL with the Top-KAST
    superset, block 16, flash_tight, one microbatch, no remat): a finite
    loss, and the grouped forward, dgrad and wgrad kernels each launched
    once per bank and layer (3 x n_layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state, make_train_step

    dev = _cuda()
    cfg = configure_kernel(get_config("qwen2-moe-a2.7b", smoke=True), kernel=kernel,
                           block=16 if kernel == "block_sparse" else None,
                           attn_kernel="flash_tight")
    cfg = dataclasses.replace(cfg, microbatches=1, remat=False,
                              sparse=dataclasses.replace(cfg.sparse, method="rigl",
                                                         kernel_block=(128, 16, 16)))
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    st, _ = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, opt, LRSchedule(kind="constant", base_lr=1e-3,
                                                warmup_steps=0))
    tok = torch.randint(0, cfg.vocab_size, (2, 32), device=dev)
    mod = tbsm if kernel == "block_sparse" else tmm
    counts = lambda: (mod.g_launches, mod.gdx_launches, mod.gdw_launches)
    c0 = counts()
    st, m = step(st, {"tokens": tok, "targets": tok.roll(-1, 1)})
    assert np.isfinite(float(m["loss"]))
    n = 3 * cfg.n_layers
    assert tuple(a - b for a, b in zip(counts(), c0)) == (n, n, n)


# (G, M, K, N, blk, dead): G = 0 is K7 (one matrix); a small bank with two
# groups that have no block; qwen2-moe's wi bank at C = 171 -> 256 rows
FUSED_SHAPES = [(0, 64, 96, 64, 16, ()), (0, 2048, 512, 384, 128, ()),
                (5, 32, 64, 96, 16, (1, 3)), (60, 256, 2048, 1408, 128, (7, 40))]


def _fused_problem(shape, dt, mdt, dev):
    """x, g, w, mom on ``dev`` and the wgrad pack entry (a superset with its
    own shared width; an empty column; the ``dead`` groups with no block)."""
    from repro_torch.core.pack import pack_entry

    G, M, K, N, blk, dead = shape
    rng = np.random.default_rng(G + M + K)
    lead = (G,) if G else ()
    bm = rng.random((*lead, K // blk, N // blk)) < 0.2
    bm[..., 0] = False
    bm[..., 0, 1] = True
    sup = bm | (rng.random(bm.shape) < 0.1)
    sup[..., 0] = False
    for g in dead:
        sup[g] = bm[g] = False
    t = lambda b: torch.from_numpy(np.repeat(np.repeat(b, blk, -2), blk, -1))
    dense = t(sup).to(dev)
    e = pack_entry(t(bm), (blk, blk), device=dev, bwd_mask=t(sup))
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    w = (f(*lead, K, N) / K ** 0.5 * dense).to(dt)
    mom = (0.1 * f(*lead, K, N) * dense).to(mdt)
    return f(*lead, M, K).to(dt), f(*lead, M, N).to(dt), w, mom, e, dense


@pytest.mark.cuda
@pytest.mark.parametrize("types", [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
                                   ("float32", "float32"), ("bfloat16", "float32")])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_cuda_block_sparse_fused_dw_matches_plain(shape, types):
    """K7 (G = 0) and K8 against their plain versions on the superset pack:
    without sr within ``fused_error_bound``; with sr bit for bit the plain
    ``sr_to_bf16`` of the kernel's own f32 m_new, on the bf16 grid; zero
    off the superset and for a group with no block; one launch each."""
    dev = _cuda()
    dt, mdt = (getattr(torch, t) for t in types)
    G, M, K, N, blk, dead = shape
    x, g, w, mom, e, dense = _fused_problem(shape, dt, mdt, dev)
    fn, plain, count = ((tbsm.grouped_block_sparse_dw_fused,
                         tbsm.grouped_block_sparse_dw_fused_plain, "g_fused_launches")
                        if G else (tbsm.block_sparse_dw_fused,
                                   tbsm.block_sparse_dw_fused_plain, "fused_launches"))
    kw = dict(mu=0.9, wd=1e-4, bn=blk, bk=blk)
    seed = 0x9E3779B9
    n0 = getattr(tbsm, count)
    got = fn(x, g, e["bidx"], e["bcnt"], w, mom, seed, sr=False, **kw)
    assert getattr(tbsm, count) == n0 + 1 and got.dtype == dt
    want = plain(x, g, e["bidx"], e["bcnt"], w, mom, seed, mu=0.9, wd=1e-4, sr=False,
                 bk=blk, bn=blk)
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, w, acc, dense)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float((diff / bound.clamp_min(1e-30)).max())
    raw = fn(x, g, e["bidx"], e["bcnt"], w, mom, seed, sr=False, out_dtype=torch.float32, **kw)
    sr = fn(x, g, e["bidx"], e["bcnt"], w, mom, seed, sr=True, **kw)
    want_sr = tmm.sr_to_bf16(raw, seed, tmm._gid(K, N, dev, G=G or None)).to(dt)
    torch.cuda.synchronize()
    assert torch.equal(sr.float(), want_sr.float())
    assert torch.equal(sr.float(), sr.to(torch.bfloat16).float())
    assert not sr[~dense].any() and not got[~dense].any()
    for gi in dead:
        assert not sr[gi].any()


@pytest.mark.cuda
@pytest.mark.parametrize("types", [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
                                   ("float32", "float32")])
@pytest.mark.parametrize("shape", FUSED_SHAPES[2:])
def test_cuda_grouped_masked_fused_dw_matches_plain(shape, types):
    """K20 against its plain version on an elementwise superset (two fully
    masked groups): without sr within ``fused_error_bound``, with sr bit
    for bit ``sr_to_bf16`` of its own f32 m_new; and on a block-aligned
    mask K8 and K20 each as that against the same plain version, and, run
    on the same tile and split (one GEMM-core walk, the same momentum
    epilogue), bit for bit one another on the support, sr off (f32 m_new)
    and on, both zero off it (K20's zeros may carry a sign, K8's are +0.0)."""
    dev = _cuda()
    dt, mdt = (getattr(torch, t) for t in types)
    G, M, K, N, blk, dead = shape
    x, g, w, mom, e, dense = _fused_problem(shape, dt, mdt, dev)
    b = dense | (torch.rand(G, K, N, device=dev) < 0.02)
    for gi in dead:
        b[gi] = False
    kw = dict(mu=0.9, wd=1e-4, bn=blk, bk=blk)
    seed = 0x9E3779B9
    n0 = tmm.g_fused_launches
    got = tmm.grouped_masked_dw_fused(x, g, b, w, mom, seed, sr=False, **kw)
    assert tmm.g_fused_launches == n0 + 1 and got.dtype == dt
    want = tmm.grouped_masked_dw_fused_plain(x, g, b, w, mom, seed, mu=0.9, wd=1e-4,
                                             sr=False)
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, w, acc, b)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float((diff / bound.clamp_min(1e-30)).max())
    raw = tmm.grouped_masked_dw_fused(x, g, b, w, mom, seed, sr=False,
                                      out_dtype=torch.float32, **kw)
    sr = tmm.grouped_masked_dw_fused(x, g, b, w, mom, seed, sr=True, **kw)
    want_sr = tmm.sr_to_bf16(raw, seed, tmm._gid(K, N, dev, G=G)).to(dt)
    assert torch.equal(sr.float(), want_sr.float()) and not sr[~b].any()
    # K8 and K20 on the block-aligned superset, each held to the plain version
    want = tmm.grouped_masked_dw_fused_plain(x, g, dense, w, mom, seed, mu=0.9, wd=1e-4,
                                             sr=False)
    bound = tmm.fused_error_bound(want, absp, M, 0.9, 1e-4, mom, w, acc, dense)
    k20 = lambda sr, o=None, p=None: tmm.grouped_masked_dw_fused(
        x, g, dense, w, mom, seed, sr=sr, out_dtype=o, plan=p, **kw)
    k8 = lambda sr, o=None, p=None: tbsm.grouped_block_sparse_dw_fused(
        x, g, e["bidx"], e["bcnt"], w, mom, seed, sr=sr, out_dtype=o, plan=p, **kw)
    for run in (k20, k8):
        diff = (run(False).float() - want.float()).abs()
        assert bool((diff <= bound).all()), float((diff / bound.clamp_min(1e-30)).max())
        want_sr = tmm.sr_to_bf16(run(False, torch.float32), seed, tmm._gid(K, N, dev, G=G))
        assert torch.equal(run(True).float(), want_sr.to(dt).float())
    torch.cuda.synchronize()
    assert torch.equal(k20(True) != 0, k8(True) != 0)
    plans = [(128, 128, 1)] + ([(128, 128, 2)] if M >= 2 * tmm.FWD_SLAB else [])
    for plan in plans:
        for sr, o in ((False, torch.float32), (True, None)):
            a = k8(sr, o, plan).float()
            b = k20(sr, o, plan).float()
            assert torch.equal(a[dense].view(torch.int32), b[dense].view(torch.int32)), (plan, sr)
            assert not a[~dense].any() and not bool(torch.signbit(a[~dense]).any())
            assert not b[~dense].any(), (plan, sr)


@pytest.mark.cuda
def test_cuda_fused_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor the fused kernels do not take raises (a mom of another
    shape or dtype, w of another dtype than x, an f32 entry asked for a bf16
    output); nothing falls back to the plain version."""
    dev = _cuda()
    x = torch.zeros(16, 32, device=dev)
    w = torch.zeros(32, 32, device=dev)
    idx = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    cnt = torch.ones(2, dtype=torch.int32, device=dev)
    kw = dict(mu=0.9, wd=0.0, sr=False, bn=16, bk=16)
    n = (tbsm.fused_launches, tbsm.g_fused_launches, tmm.g_fused_launches)
    with pytest.raises(TypeError, match="mom"):
        tbsm.block_sparse_dw_fused(x, x, idx, cnt, w, w.double(), 0, **kw)
    with pytest.raises(ValueError, match="do not match"):
        tbsm.block_sparse_dw_fused(x, x, idx, cnt, w, w[:16], 0, **kw)
    with pytest.raises(TypeError, match="like x"):
        tbsm.block_sparse_dw_fused(x, x, idx, cnt, w.bfloat16(), w, 0, **kw)
    with pytest.raises(TypeError, match="output"):
        tbsm.block_sparse_dw_fused(x, x, idx, cnt, w, w, 0, out_dtype=torch.bfloat16, **kw)
    with pytest.raises(ValueError, match="3-D"):
        tbsm.grouped_block_sparse_dw_fused(x, x, idx[None], cnt[None], w, w, 0, **kw)
    m = torch.ones(2, 32, 32, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="bool"):
        tmm.grouped_masked_dw_fused(x[None].expand(2, -1, -1).contiguous(),
                                    x[None].expand(2, -1, -1).contiguous(), m.float(),
                                    w[None].expand(2, -1, -1).contiguous(),
                                    w[None].expand(2, -1, -1).contiguous(), 0, **kw)
    assert (tbsm.fused_launches, tbsm.g_fused_launches, tmm.g_fused_launches) == n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b"])
def test_cuda_block_sparse_fused_training_step_runs_k7(arch, monkeypatch):
    """A SMOKE train step with the fused SGD epilogue under
    kernel='block_sparse' (bf16 state, sr; RigL with the superset pack) on
    the card launches K7 on every projection (and K8 on every bank) and no
    K3 (K6); its loss, new momentum and params agree with the same step on
    the CPU (plain versions; MoE routing pinned to the CPU run's) within
    bf16 tolerance (``_fused_state_agrees``), the momentum stored in bf16."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps

    dev = _cuda()
    cfg = dataclasses.replace(
        get_config(arch, smoke=True), microbatches=1,
        sparse=SparseConfig(sparsity=0.8, kernel="block_sparse", block_shape=(16, 16),
                            kernel_block=(128, 16, 16), attn_kernel="flash_tight",
                            fused_epilogue=True))
    opt = OptConfig(kind="sgd", momentum=0.9, weight_decay=1e-4, state_dtype="bfloat16")
    lr = LRSchedule(kind="constant", base_lr=1e-3, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 32)))
    batch = {"tokens": toks, "targets": (toks * 3 + 7) % 128}
    read = lambda: [tbsm.dw_launches, tbsm.fused_launches, tbsm.gdw_launches,
                    tbsm.g_fused_launches]
    losses, states, pin = [], [], _pin_routing(monkeypatch)
    for device in ("cpu", dev):
        if device != "cpu":
            pin()
        st, _ = steps.init_train_state(cfg, opt, seed=0, device="cpu")
        st = {k: _to(v, device) for k, v in st.items()}
        before = read()
        st, m = steps.make_train_step(cfg, opt, lr)(
            st, {k: v.to(device) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        states.append(st)
        after = read()
    n_banks = 3 * cfg.n_layers if cfg.n_experts else 0
    n_proj = 7 * cfg.n_layers
    assert [b - a for a, b in zip(before, after)] == [0, n_proj, 0, n_banks]
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[0])
    assert all(t.dtype == torch.bfloat16 for t in _leaves(st["opt"]["momentum"]))
    _fused_state_agrees(states[0], st, lr.base_lr)


@pytest.mark.cuda
def test_cuda_moe_masked_fused_training_step_runs_k20(monkeypatch):
    """A qwen2-moe SMOKE train step with the fused SGD epilogue under
    kernel='masked' on the card: K19 on every projection, K20 on every
    bank, no K15/K18; its loss, new momentum and params agree with the CPU
    step's, routing pinned to the CPU run's (``_fused_state_agrees``)."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps

    dev = _cuda()
    cfg = dataclasses.replace(
        get_config("qwen2-moe-a2.7b", smoke=True), microbatches=1,
        sparse=SparseConfig(sparsity=0.8, kernel="masked", kernel_block=(128, 16, 16),
                            attn_kernel="flash_tight", fused_epilogue=True))
    opt = OptConfig(kind="sgd", momentum=0.9, weight_decay=1e-4, state_dtype="bfloat16")
    lr = LRSchedule(kind="constant", base_lr=1e-3, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 32)))
    batch = {"tokens": toks, "targets": (toks * 3 + 7) % 128}
    read = lambda: [tmm.dw_launches, tmm.fused_launches, tmm.gdw_launches,
                    tmm.g_fused_launches]
    losses, states, pin = [], [], _pin_routing(monkeypatch)
    for device in ("cpu", dev):
        if device != "cpu":
            pin()
        st, _ = steps.init_train_state(cfg, opt, seed=0, device="cpu")
        st = {k: _to(v, device) for k, v in st.items()}
        before = read()
        st, m = steps.make_train_step(cfg, opt, lr)(
            st, {k: v.to(device) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        states.append(st)
        after = read()
    assert [b - a for a, b in zip(before, after)] == [0, 7 * cfg.n_layers, 0,
                                                      3 * cfg.n_layers]
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[0])
    _fused_state_agrees(states[0], st, lr.base_lr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,density", [((1000,), 1.0), ((3, 777), 1.0),
                                           ((1027, 4099), 1.0), ((2560, 6912), 0.2)])
def test_cuda_histogram_abs_matches_plain(shape, density, dtype):
    """K21 against its plain version in every bin (integer counts: exact),
    the limits above max|x| and inside the range, a NaN and an inf, a
    misaligned view (the wrapper copies it), and a masked weight whose zeros
    crowd bin 0; then ``topk_threshold`` through K21 bit for bit against the
    plain path, with 2 launches (1 without the refinement)."""
    from repro_torch.kernels import topk_threshold as ttk
    from repro_torch.kernels.ops import topk_threshold

    dev = _cuda()
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.random(shape) < density
    x.reshape(-1)[[0, 5]] = np.nan, np.inf
    x = torch.from_numpy(x).to(dev, dtype)
    finite = x.float().nan_to_num(0.0, 0.0, 0.0).abs().max()
    for hi in (finite + 1e-12, 0.5 * finite):
        got = ttk.histogram_counts(x, hi)
        assert torch.equal(got, ttk.histogram_counts_plain(x, hi))
        assert int(got.sum()) == x.numel()
        assert torch.equal(ttk.histogram_abs(x, hi), got.float()[None])
    view = x.reshape(-1)[1:]
    assert torch.equal(ttk.histogram_counts(view, finite),
                       ttk.histogram_counts_plain(view, finite))
    clean = torch.nan_to_num(x, 0.0, 0.0, 0.0)
    k = max(1, clean.numel() // 100)
    for refine, n_launch in ((True, 2), (False, 1)):
        before = ttk.launches
        got = topk_threshold(clean, k, refine=refine)
        assert ttk.launches - before == n_launch
        want = topk_threshold(clean, k, refine=refine, histogram=ttk.histogram_abs_plain)
        assert got.view(torch.int32).item() == want.view(torch.int32).item()


# ---------------------------------------------------------------------------
# checkpoints of card tensors, and the engine's quarantine on the card
# ---------------------------------------------------------------------------


def _card_state(dev):
    """A smoke train state on the card with every kind of leaf: f32 params,
    bf16 SGD momentum, bool masks, int32 packs, host ints."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), sparse=SparseConfig(
        sparsity=0.8, method="rigl", kernel="block_sparse", block_shape=(16, 16),
        kernel_block=(128, 16, 16)))
    st, _ = init_train_state(cfg, OptConfig(kind="sgd", state_dtype="bfloat16"),
                             seed=1, device=dev)
    from repro_torch.core.masks import tree_map

    tree_map(lambda _, m: m.normal_(), st["opt"]["momentum"])
    return st


def _same_tree(a, b):
    from repro_torch.core.masks import tree_map

    out = []
    tree_map(lambda n, x, y: out.append((n, x, y)), a, b)
    for n, x, y in out:
        if not torch.is_tensor(x):
            assert x == y, n
            continue
        assert x.dtype == y.dtype and x.device == y.device and x.shape == y.shape, n
        if x.is_floating_point():
            x, y = (t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                    for t in (x, y))
        assert torch.equal(x, y), n


@pytest.mark.cuda
def test_cuda_checkpoint_round_trips_card_tensors(tmp_path):
    """Card tensors (f32, bf16, bool, int32) and host ints round-trip bit
    for bit and restore onto the card, as the template lies."""
    from repro_torch.checkpoint import restore, save

    dev = _cuda()
    st = _card_state(dev)
    save(st, tmp_path, 3)
    got, step = restore(st, tmp_path)
    assert step == 3 and got["params"]["embed"]["table"].is_cuda
    _same_tree(got, st)


@pytest.mark.cuda
def test_cuda_async_snapshot_isolated_from_inplace_updates(tmp_path):
    """``maybe_save`` returns with an owned host copy of the card state:
    in-place updates on the card right after it never reach the file."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.masks import tree_map

    dev = _cuda()
    st = _card_state(dev)
    want = tree_map(lambda _, v: v.clone() if torch.is_tensor(v) else v, st)
    ck = Checkpointer(tmp_path, every=1)
    ck.maybe_save(st, 5)
    tree_map(lambda _, v: v.add_(1.0), st["params"])
    tree_map(lambda _, v: v.zero_(), st["opt"]["momentum"])
    ck.wait()
    got, step = ck.restore_or_none(st)
    assert step == 5
    _same_tree(got, want)


@pytest.mark.cuda
def test_cuda_engine_quarantines_injected_faults():
    """A ``FaultInjector`` on the card: a NaN written into one active slot's
    logits row quarantines that request alone (retried to the fault-free
    stream), a poisoned prefill exhausts its retry to FAILED, and the
    trace's quarantine instants join the engine's log."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_lm
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.faults import FaultInjector, burst_storm
    from repro_torch.serving.queue import Status

    dev = _cuda()
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), dtype="float32")
    params, _ = init_lm(cfg, 0, device=dev)

    def serve(faults, obs=None):
        eng = ServeEngine(cfg, params, capacity=3, max_len=32, faults=faults,
                          obs=obs, max_retries=1)
        for r in burst_storm(cfg, 6, prompt_len=8, max_new_tokens=6):
            eng.submit(r)
        now = 0.0
        while len(eng.queue) or eng.active.any():
            eng.step(now)
            now += 1.0
        return eng

    clean = {r.rid: r.generated for r in serve(None).queue.done}
    obs = Observability(metrics=MetricsRegistry())
    eng = serve(FaultInjector().poison_logits(2, 0).poison_prefill(4), obs)
    status = {r.rid: r.status for r in eng.queue.done}
    assert status[4] is Status.FAILED
    assert all(status[r] is Status.DONE for r in (0, 1, 2, 3, 5))
    assert {r.rid: r.generated for r in eng.queue.done if r.rid != 4} == {
        r: clean[r] for r in (0, 1, 2, 3, 5)}
    assert eng.quarantine_log[0] == (2, 0, 0, 0, "decode")
    quar = obs.trace.find("quarantine")
    assert [(e["args"]["step"], e["args"]["rid"], e["args"]["slot"],
             e["args"]["attempt"], e["args"]["where"]) for e in quar] == [
        tuple(q) for q in eng.quarantine_log]


# sLSTM's recurrent bank r of xlstm-1.3b: 4 heads, 512 -> 2048, at a
# request's step (C = 1), a decode step (8) and a training batch's padded
# rows (16); f32, the path's dtype
R_BANK = (4, 512, 2048)


def _r_bank_problem(C, dev):
    """x (G, C->16, K), g (G, C->16, N), a 20% 128x128-block mask with a
    superset (10% more blocks) and its pack entry, w zero outside the
    mask; the elementwise masks for the masked kernels."""
    from repro_torch.core.pack import pack_entry

    G, K, N = R_BANK
    blk = 128
    rng = np.random.default_rng(C)
    bm = rng.random((G, K // blk, N // blk)) < 0.2
    bm[:, 0, 0] = True
    sup = bm | (rng.random(bm.shape) < 0.1)
    t = lambda b: torch.from_numpy(np.repeat(np.repeat(b, blk, -2), blk, -1)).to(dev)
    m, b = t(bm), t(sup)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 16 - C))
    w = f(G, K, N) / K ** 0.5 * m
    x, g = pad(f(G, C, K)), pad(f(G, C, N))
    return x, g, w, m, b, pack_entry(m, (blk, blk), device=dev, bwd_mask=b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 16])
def test_cuda_r_bank_grouped_kernels_match_plain(C):
    """K4, K5, K6 (block-sparse, 128x128) and K16, K17, K18 (masked) at the
    r bank's shapes against their plain versions, each within
    ``matmul_error_bound``; the wgrads zero outside the superset."""
    dev = _cuda()
    x, g, w, m, b, e = _r_bank_problem(C, dev)
    G, K, N = R_BANK
    blk = 128
    ab = lambda t: t.abs()
    runs = {
        "K4": (lambda: tbsm.grouped_block_sparse_matmul(x, w, e["idx"], e["cnt"], bm=16,
                                                         bn=blk, bk=blk, live=e["nnz"]),
               lambda a, c: tbsm.grouped_block_sparse_matmul_plain(a, c, e["idx"].cpu(),
                                                                   e["cnt"].cpu(), blk, blk),
               (x, w), K),
        "K5": (lambda: tbsm.grouped_block_sparse_dx(g, w, e["ridx"], e["rcnt"], bm=16, bn=blk,
                                                     bk=blk, live=e["nnz"]),
               lambda a, c: tbsm.grouped_block_sparse_dx_plain(a, c, e["ridx"].cpu(),
                                                               e["rcnt"].cpu(), blk, blk),
               (g, w), N),
        "K6": (lambda: tbsm.grouped_block_sparse_dw(x, g, e["bidx"], e["bcnt"], bn=blk, bk=blk,
                                                     live=e["bnnz"]),
               lambda a, c: tbsm.grouped_block_sparse_dw_plain(a, c, e["bidx"].cpu(),
                                                               e["bcnt"].cpu(), blk, blk),
               (x, g), 16),
        "K16": (lambda: tmm.grouped_masked_matmul(x, w, m, bm=16, bn=blk),
                lambda a, c: tmm.grouped_masked_matmul_plain(a, c, m.cpu()), (x, w), K),
        "K17": (lambda: tmm.grouped_masked_dx(g, w, m, bm=16, bk=blk),
                lambda a, c: tmm.grouped_masked_dx_plain(a, c, m.cpu()), (g, w), N),
        "K18": (lambda: tmm.grouped_masked_dw(x, g, b, bn=blk, bk=blk),
                lambda a, c: tmm.grouped_masked_dw_plain(a, c, b.cpu()), (x, g), 16),
    }
    for name, (run, plain, (a, c), n) in runs.items():
        got = run()
        torch.cuda.synchronize()
        want = plain(a.cpu(), c.cpu())
        assert _bound_ok(got, want, plain(ab(a).cpu(), ab(c).cpu()), n), name
        if name in ("K6", "K18"):
            assert float(got[~b].abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_xlstm_training_step_runs_the_recurrent_bank(kernel):
    """An xlstm SMOKE train step on the card (RigL with the Top-KAST
    superset, block 16, one microbatch, no remat): a finite loss, and the
    grouped forward, dgrad and wgrad kernels launched once per sLSTM layer
    and time step (the dgrad one step fewer: the zero initial state takes
    no gradient), the 2-D kernels 5 times per mLSTM and 2 per sLSTM layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state, make_train_step

    dev = _cuda()
    cfg = configure_kernel(get_config("xlstm-1.3b", smoke=True), kernel=kernel,
                           block=16 if kernel == "block_sparse" else None)
    cfg = dataclasses.replace(cfg, microbatches=1, remat=False,
                              sparse=dataclasses.replace(cfg.sparse, method="rigl",
                                                         kernel_block=(128, 16, 16)))
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    st, _ = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, opt, LRSchedule(kind="constant", base_lr=1e-3,
                                                warmup_steps=0))
    S = 24
    tok = torch.randint(0, cfg.vocab_size, (2, S), device=dev)
    mod = tbsm if kernel == "block_sparse" else tmm
    counts = lambda: (mod.launches, mod.dx_launches, mod.dw_launches, mod.g_launches,
                      mod.gdx_launches, mod.gdw_launches)
    c0 = counts()
    st, m = step(st, {"tokens": tok, "targets": tok.roll(-1, 1)})
    assert np.isfinite(float(m["loss"]))
    n_s = sum(cfg.is_slstm(i) for i in range(cfg.n_layers))
    proj = 5 * (cfg.n_layers - n_s) + 2 * n_s
    assert tuple(a - b for a, b in zip(counts(), c0)) == (
        proj, proj, proj, S * n_s, (S - 1) * n_s, S * n_s)


# hymba-1.5b's attention: 5 query heads a KV head, head_dim 64; a local
# layer's window and a global layer, at ragged lengths
HYMBA_FLASH = {"window G=5": (600, 256), "global G=5": (520, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HYMBA_FLASH))
def test_cuda_flash_d64_matches_plain(case):
    """K9, K10 and K11 at d = 64 (10 query heads over 2 KV heads) against
    their plain versions, element by element within ``o_error_bound`` and
    ``grad_error_bound``, on their exact d = 64 instantiations (8 warps for
    K9 and K10, no spill); the generic instantiation gives the same within
    the same bounds."""
    dev = _cuda()
    S, window = HYMBA_FLASH[case]
    G, d, BH = 5, 64, 10
    assert tfa.launch_info("flash_fwd", d)["warps"] == 8
    assert tfa.launch_info("flash_fwd", d, generic=True)["warps"] == 4
    rng = np.random.default_rng(13)
    r = lambda n: torch.from_numpy(rng.standard_normal((n, S, d)).astype(np.float32)).to(
        torch.bfloat16)
    q, k, v, do = r(BH), r(BH // G), r(BH // G), r(BH)
    bq, bk = tfa.effective_blocks(S, S)
    Sp = -(-S // bq) * bq
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - t.shape[1]))
    q, k, v, do = pad(q), pad(k), pad(v), pad(do)
    sched = tfa._schedule_on(torch.device("cpu"), S, S, bq, bk, True, window, 0)
    kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
              scale=d ** -0.5, softcap=0.0, kv_groups=G)
    po, plse = tfa.flash_fwd(q, k, v, sched[0], sched[1], **kw)
    pa, _ = tfa.flash_fwd(q, k, v.abs(), sched[0], sched[1], **kw)
    delta = (do.float() * po.float()).sum(-1)
    blocks = tfa._schedule_mask(sched[0], sched[1], Sp // bk, "cpu")
    *want, dq_a, dk_a, dv_a, dq_e, dk_e, dv_e = tfa.flash_bwd_plain(
        q, k, v, do, plse, delta, blocks, with_abs=True, **kw)
    on = lambda *ts: [t.to(dev) for t in ts]
    for generic in (False, True):
        o, lse = tfa.flash_fwd(*on(q, k, v, sched[0], sched[1]), generic=generic, **kw)
        assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
        assert (lse.cpu() - plse).abs().max().item() <= 1e-3
        args = on(q, k, v, do, plse, delta)
        dq = tfa.flash_dq(*args, *on(sched[0], sched[1]), generic=generic, **kw)
        dk, dv = tfa.flash_dkv(*args, *on(sched[2], sched[3]), generic=generic, **kw)
        for name, got, w_, a, e in (("dq", dq, want[0], dq_a, dq_e),
                                    ("dk", dk, want[1], dk_a, dk_e),
                                    ("dv", dv, want[2], dv_a, dv_e)):
            diff = (got.float().cpu() - w_.float()).abs()
            assert bool((diff <= tfa.grad_error_bound(w_, a, e)).all()), (name, generic)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_hymba_prefill_decode_and_training_step(kernel):
    """hymba SMOKE on the card (block 16, flash_tight): a prefill and two
    decode steps with slot 0 parked (its SSM state bit for bit unchanged;
    the logits within 5e-3 of the CPU's plain path on the same weights), 9
    K1 (K13) launches a layer a call; then a RigL train step (Top-KAST
    superset, one microbatch, no remat): a finite loss, 9 forward, dgrad
    and wgrad launches a layer and one K9, K10 and K11 a layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel, init_serving_state
    from repro_torch.models import model as tm
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state, make_train_step

    dev = _cuda()
    cfg = configure_kernel(get_config("hymba-1.5b", smoke=True), kernel=kernel, block=16,
                           attn_kernel="flash_tight")
    cfg = dataclasses.replace(cfg, microbatches=1, remat=False,
                              sparse=dataclasses.replace(cfg.sparse, method="rigl",
                                                         kernel_block=(128, 16, 16)))
    mod = tbsm if kernel == "block_sparse" else tmm
    params, masks, pack = init_serving_state(cfg, seed=0, device="cpu")
    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v) for v in t]
        return t.to(dev) if torch.is_tensor(t) else t

    sides = {"cpu": (torch.device("cpu"), tm.serving_weights(params, cfg), masks, pack),
             "cuda": (dev, tm.serving_weights(to(params), cfg), to(masks), to(pack))}
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20))).long()
    out = {}
    for side, (on, w, m, pk) in sides.items():
        n0 = mod.launches
        logits, caches = tm.lm_prefill(w, cfg, {"tokens": toks.to(on)}, 32, masks=m, pack=pk)
        if side == "cuda":
            assert mod.launches - n0 == 9 * cfg.n_layers
        steps = [logits[:, -1]]
        active = torch.tensor([False, True], device=on)
        parked = [{k: v[0].clone() for k, v in c["ssm"].items()} for c in caches]
        for t in range(2):
            tok = steps[-1].argmax(-1)[:, None]
            lg, caches = tm.lm_decode(w, cfg, caches, tok, torch.full((2,), 20 + t, device=on),
                                      masks=m, pack=pk, active=active)
            steps.append(lg[:, -1])
        for c, b in zip(caches, parked):
            assert all(torch.equal(c["ssm"][k][0], v) for k, v in b.items())
        out[side] = [s_.float().cpu() for s_ in steps]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a[1] - b[1]).abs().max().item() <= 5e-3 * b[1].abs().max().item()
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    st, _ = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, opt, LRSchedule(kind="constant", base_lr=1e-3,
                                                warmup_steps=0))
    tok = torch.randint(0, cfg.vocab_size, (2, 40), device=dev)
    counts = lambda: (mod.launches, mod.dx_launches, mod.dw_launches, tfa.launches,
                      tfa.dq_launches, tfa.dkv_launches)
    c0 = counts()
    st, met = step(st, {"tokens": tok, "targets": tok.roll(-1, 1)})
    assert np.isfinite(float(met["loss"]))
    n = cfg.n_layers
    assert tuple(a - b for a, b in zip(counts(), c0)) == (9 * n, 9 * n, 9 * n, n, n, n)


# gemma3-4b's attention: 2 query heads a KV head (8 over 4), head_dim 256; a
# local layer's window and a global layer, at odd lengths
GEMMA_FLASH = {"window G=2 S=601": (601, 256), "global G=2 S=515": (515, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (True, 3)], ids=["planned", "paired-split3"])
@pytest.mark.parametrize("case", sorted(GEMMA_FLASH))
def test_cuda_flash_d256_matches_plain(monkeypatch, case, plan):
    """K9, K10 and K11 on their exact d = 256 instantiations (8 query heads
    over 4 KV heads, causal) against their plain versions, element by
    element within ``o_error_bound`` and ``grad_error_bound``; under the
    wrapper's own plan and under a forced one that pairs units and splits
    every walk in three (the partials merged by flash_bwd_merge_kernel).
    K9 runs 8 warps, 1 CTA an SM; none of the three spills."""
    dev = _cuda()
    S, window = GEMMA_FLASH[case]
    G, d, BH = 2, 256, 8
    info = tfa.launch_info("flash_fwd", d, 16)
    assert (info["warps"], info["ctas_per_sm"], info["spill_bytes"]) == (8, 1, 0), info
    if plan is not None:
        monkeypatch.setattr(tfa, "_bwd_plan_for", lambda *a, **k: plan)
    rng = np.random.default_rng(17)
    r = lambda n: torch.from_numpy(rng.standard_normal((n, S, d)).astype(np.float32)).to(
        torch.bfloat16)
    q, k, v, do = r(BH), r(BH // G), r(BH // G), r(BH)
    bq, bk = tfa.effective_blocks(S, S)
    Sp = -(-S // bq) * bq
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - t.shape[1]))
    q, k, v, do = pad(q), pad(k), pad(v), pad(do)
    sched = tfa._schedule_on(torch.device("cpu"), S, S, bq, bk, True, window, 0)
    kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
              scale=d ** -0.5, softcap=0.0, kv_groups=G)
    po, plse = tfa.flash_fwd(q, k, v, sched[0], sched[1], **kw)
    pa, _ = tfa.flash_fwd(q, k, v.abs(), sched[0], sched[1], **kw)
    delta = (do.float() * po.float()).sum(-1)
    blocks = tfa._schedule_mask(sched[0], sched[1], Sp // bk, "cpu")
    *want, dq_a, dk_a, dv_a, dq_e, dk_e, dv_e = tfa.flash_bwd_plain(
        q, k, v, do, plse, delta, blocks, with_abs=True, **kw)
    on = lambda *ts: [t.to(dev) for t in ts]
    o, lse = tfa.flash_fwd(*on(q, k, v, sched[0], sched[1]), **kw)
    assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse.cpu() - plse).abs().max().item() <= 1e-3
    args = on(q, k, v, do, plse, delta)
    dq = tfa.flash_dq(*args, *on(sched[0], sched[1]), **kw)
    dk, dv = tfa.flash_dkv(*args, *on(sched[2], sched[3]), **kw)
    for name, got, w_, a, e in (("dq", dq, want[0], dq_a, dq_e),
                                ("dk", dk, want[1], dk_a, dk_e),
                                ("dv", dv, want[2], dv_a, dv_e)):
        diff = (got.float().cpu() - w_.float()).abs()
        assert bool((diff <= tfa.grad_error_bound(w_, a, e)).all()), name
    with pytest.raises(ValueError, match="generic"):
        tfa.flash_fwd(*on(q, k, v, sched[0], sched[1]), generic=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_bf16_bank_under_f32_compute_matches_plain(kernel):
    """grok-1-314b's banks: a bf16 master under f32 compute goes into the
    grouped Function as it is and is upcast there for each launch (K4-K6,
    or K16-K18).  The card's output and x's gradient within
    ``matmul_error_bound`` of the same call on the CPU (the plain
    versions), w's gradient bf16 and within the bound of a bf16 output
    (each side sums in f32 and rounds once)."""
    from repro_torch.core.pack import pack_entry
    from repro_torch.kernels import ops as tops

    dev = _cuda()
    rng = np.random.default_rng(34)
    G, M, K, N, blk = 3, 40, 64, 48, 16
    bm = rng.random((G, K // blk, N // blk)) < 0.4
    bm[:, 0, 0] = True
    sup = bm | (rng.random(bm.shape) < 0.2)
    dense = lambda b: torch.from_numpy(np.repeat(np.repeat(b, blk, 1), blk, 2))
    mask, smask = dense(bm), dense(sup)
    w = (torch.from_numpy(rng.standard_normal((G, K, N)).astype(np.float32)) * smask) \
        .to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((G, M, K)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((G, M, N)).astype(np.float32))

    def run(device):
        xd = x.to(device).requires_grad_(True)
        wd = w.to(device).requires_grad_(True)
        if kernel == "block_sparse":
            e = pack_entry(mask.to(device), (blk, blk), bwd_mask=smask.to(device))
            y = tops.grouped_block_sparse_linear(xd, wd, pack=e, block=(128, blk, blk))
        else:
            y = tops.topkast_grouped_masked_linear(xd, wd, mask.to(device), smask.to(device),
                                                   block=(128, blk, blk))
        dx, dw = torch.autograd.grad(y, (xd, wd), g.to(device))
        return y.detach().cpu(), dx.cpu(), dw.cpu()

    y, dx, dw = run(dev)
    py, pdx, pdw = run("cpu")
    assert dw.dtype == pdw.dtype == torch.bfloat16 and y.dtype == torch.float32
    wf = w.float()
    ay = torch.bmm(x.abs(), (wf * mask).abs())
    adx = torch.bmm(g.abs(), (wf * mask).abs().transpose(1, 2))
    adw = torch.bmm(x.abs().transpose(1, 2), g.abs()) * smask
    assert _bound_ok(y, py, ay, K)
    assert _bound_ok(dx, pdx, adx, N)
    assert _bound_ok(dw, pdw, adw, M)
    assert not dw[~smask].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_cuda_remat_dots_keeps_the_kernels_opaque(kernel):
    """remat_policy='dots' around the hand-written kernels (danube SMOKE,
    flash_tight, remat per layer): the same launches of every kernel as
    under 'none' (each forward kernel rerun in the backward, nothing of it
    saved) and every gradient equal bit for bit."""
    import dataclasses

    from repro_torch.configs import SparseConfig, get_config
    from repro_torch.core.masks import tree_map, tree_paths
    from repro_torch.models.model import lm_loss
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps

    dev = _cuda()
    sp = dict(sparsity=0.8, method="rigl", kernel=kernel, attn_kernel="flash_tight")
    if kernel == "block_sparse":
        sp.update(block_shape=(16, 16), kernel_block=(128, 16, 16))
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), remat=True,
                              sparse=SparseConfig(**sp))
    st, _ = steps.init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 64))).to(dev)
    batch = {"tokens": toks, "targets": (toks * 3 + 7) % 128}
    mods = (tbsm, tmm, tfa)
    names = lambda m: [a for a in vars(m) if a.endswith("launches")]
    out = {}
    for policy in ("none", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        before = {(m, a): getattr(m, a) for m in mods for a in names(m)}
        src = tree_map(lambda _, t: t.detach().requires_grad_(True), st["params"])
        loss = lm_loss(src, c, batch, masks=st["masks"], pack=st["pack"])
        grads = torch.autograd.grad(loss, list(tree_paths(src).values()))
        torch.cuda.synchronize()
        counts = {(m.__name__, a): getattr(m, a) - v for (m, a), v in before.items()}
        out[policy] = (loss.item(), grads, counts)
    assert out["none"][2] == out["dots"][2]
    assert sum(out["dots"][2].values()) > 0
    assert out["none"][0] == out["dots"][0]
    for a, b in zip(out["none"][1], out["dots"][1]):
        assert torch.equal(a, b)


GLOO_RANK = """
import sys
import torch
import torch.distributed as dist
from repro_torch.training import steps

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank)
steps._BUCKET_BYTES = 4096  # several buckets a dtype
g = torch.Generator().manual_seed(0)
# quarters of small integers: b + rank and the mean b + 0.5 are exact in bf16
base = [(torch.randint(-64, 64, (n,), generator=g) * 0.25).to(dt) for n, dt in
        ((3000, torch.float32), (5, torch.float32), (2500, torch.bfloat16), (1, torch.float32))]
ts = [(b + rank).cuda() for b in base]
steps._all_reduce_mean(ts, dist.group.WORLD, 2)
ok = all(t.is_cuda and torch.equal(t.cpu(), b + 0.5) for t, b in zip(ts, base))
print("OK" if ok else "MISMATCH")
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_gloo_all_reduce_means_cuda_tensors(tmp_path):
    """The train step's bucketed all-reduce on CUDA tensors over two gloo
    ranks sharing the card (gloo stages them through the host; NCCL
    refuses two ranks on one device): f32 and bf16 leaves across several
    buckets come back as the exact mean, on the card."""
    import os
    import subprocess
    import sys

    _cuda()
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_RANK, str(r), str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        assert out.strip().splitlines()[-1] == "OK"
