"""K1/K4's launch plan and its split, and the plain K1, K2, K4 and K5 on a
non-finite x or g, on the CPU.

The block-sparse forward runs on the GEMM core, one CTA a (column tile, row
tile) of y walking its block column's packed list of active K-blocks, and
takes its own plan (``block_sparse_matmul.fwd_plan``: rows Mp, contraction
K, columns N, the grid counted as column tiles x row tiles x G, a column's
walk the mean of the forward pack's live blocks, the split chosen by the
core's ``masked_matmul.fwd_split``): its picks at
the main paths' shapes (given as numbers), the plain version that follows a
split (``block_sparse_matmul_split_plain``: f32 partials over whole slabs
of each column's list, summed in split order, rounded once) against the
unsplit plain version and the reference's kernels, and the forward's live
count handed down from a pack entry (its ``nnz``, never a superset's
``bnnz``).

The plain K1, K2, K4 and K5 sum each product over the pack's active blocks
only: an inf or NaN in x (K1, K4) or g (K2, K5) reaches only the outputs
whose blocks read it, as the reference's kernels (``_fwd_call``,
``_dx_call``, ``_g_fwd_call``, ``_g_dx_call`` in interpret mode), which
never read an inactive block.

The CUDA kernel runs only on a card: tests/test_torch_cuda.py forces every
candidate plan there and holds each against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro_torch.core.pack import pack_group_mask, pack_group_mask_rows, pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear, grouped_block_sparse_linear  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
# CTAs resident per SM of the forward's tiles (the H100 build's occupancy,
# read back from the runtime on an NVIDIA H100 80GB HBM3; the wrapper reads
# it there): 128 x 128 and 16 x 64
CTAS = {(128, BF): 2, (128, F32): 1, (16, BF): 8, (16, F32): 4}
# relative to the largest finite magnitude: f32 the same products summed in
# another order; bf16 one ulp (both round once)
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


def _plan(Mp, K, N, G, dt, live, blk=128):
    """K1/K4's plan of x (G, Mp, K) @ w (G, K, N) on ``live`` active blocks
    of blk x blk."""
    slots = SMS * CTAS[(16 if Mp <= 64 else 128, dt)]
    return tbsm.fwd_plan(Mp, K, N, G, dt, slots, bk=blk, bn=blk, live=live)


# the forward shapes of the main paths (x (G, Mp, K) @ w (G, K, N), rows
# padded), the dtype (attention in bf16, the MLP and the banks in f32), the
# forward pack's live 128 x 128 blocks (the pack entries' nnz at ERK 0.8: a
# dense layer keeps all), and the plan's pick
BS_FWD = {
    # decode, 4 rows -> 16 (8 bf16 and 4 f32 CTAs an SM): the split fills
    # the slots in one wave as far as the partials' cap (a quarter of the
    # live blocks' bytes) allows: wq's 40 column tiles walk 5 blocks (19
    # slabs) a column, cap 2; wk's 10 walk 12 (48 slabs), cap 6; the f32
    # MLP's 108 (wi: 13 blocks, cap 3) and 40 (wo: 8.9, cap 8), 528 slots
    "danube decode wq/wo": ((16, 1, 2560, 2560, BF, 96), (16, 64, 2)),
    "danube decode wk/wv": ((16, 1, 2560, 640, BF, 60), (16, 64, 6)),
    "danube decode mlp wi/wg": ((16, 1, 2560, 6912, F32, 178), (16, 64, 3)),
    "danube decode mlp wo": ((16, 1, 6912, 2560, F32, 178), (16, 64, 8)),
    # 2048 rows: wq's 320 CTAs (1.2 waves of 264) stay whole, the merge of
    # a split's 2048 x 2560 partials costing more than the idle wave; wk's
    # 80 (0.3 waves) split in 2 (4 would need a second wave); the f32 MLP's
    # wi (864 CTAs on 132, 6.5 waves) stays whole, wo's 320 (2.4 waves, 35
    # slabs a column) splits in 2 (5 waves of 18)
    "danube 2048 wq/wo": ((2048, 1, 2560, 2560, BF, 96), (128, 128, 1)),
    "danube 2048 wk/wv": ((2048, 1, 2560, 640, BF, 60), (128, 128, 2)),
    "danube 2048 mlp wi/wg": ((2048, 1, 2560, 6912, F32, 178), (128, 128, 1)),
    "danube 2048 mlp wo": ((2048, 1, 6912, 2560, F32, 178), (128, 128, 2)),
    # mistral-large's wk at a decode step's 16 rows: all 96 x 8 blocks live,
    # 16 column tiles, 384 slabs a column: the largest split, 512 CTAs on
    # 1056 slots
    "mistral decode wk": ((16, 1, 12288, 1024, BF, 768), (16, 64, 32)),
    # qwen2-moe's 60-expert banks: 1320 (wi) and 1920 (wo) CTAs at 16 rows
    # fill the slots alone; at C 171 -> 256 they stay whole
    "qwen2-moe bank wi C=16": ((16, 60, 2048, 1408, F32, 1276), (16, 64, 1)),
    "qwen2-moe bank wo C=16": ((16, 60, 1408, 2048, F32, 1276), (16, 64, 1)),
    "qwen2-moe bank wi C=256": ((256, 60, 2048, 1408, F32, 1276), (128, 128, 1)),
    "qwen2-moe bank wo C=256": ((256, 60, 1408, 2048, F32, 1276), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(BS_FWD))
def test_bs_fwd_plan_at_the_paths_shapes(name):
    """The plan's pick at each main path's forward shape, on the forward
    pack's live blocks; every candidate a sweep forces is a built tile of
    the pick's rows, each with a split that walks at least FWD_MIN_SLABS of
    a column's mean slabs, the pick among them."""
    (Mp, G, K, N, dt, live), want = BS_FWD[name]
    assert _plan(Mp, K, N, G, dt, live) == want
    slots = SMS * CTAS[(want[0], dt)]
    cands = tbsm.fwd_candidates(Mp, K, N, G, dt, slots, bk=128, bn=128, live=live)
    assert want in cands
    assert all((bm, bn) in tmm.FWD_TILES and bm == want[0] for bm, bn, _ in cands)
    mean_slabs = live * 4 // (G * N // 128)
    assert all(n == 1 or n <= mean_slabs // tmm.FWD_MIN_SLABS for *_, n in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_bs_fwd_plan_follows_the_forward_live_blocks(dt):
    """The walk is the forward pack's live blocks: a sparser pack walks
    fewer slabs a column, so it splits less at decode and never more at
    2048 rows; every block live (20 a column) splits at decode where 100 of
    the 1080 (5 slabs a column) do not.  A block
    of 16-64 columns runs in 64-column tiles at every row count (a tile
    never spans two block columns), each block column one tile; bk below a
    slab walks one slab a block."""
    K, N = 2560, 6912
    assert _plan(16, K, N, 1, dt, 40)[2] <= _plan(16, K, N, 1, dt, 400)[2]
    assert _plan(2048, K, N, 1, dt, 40)[2] <= _plan(2048, K, N, 1, dt, 400)[2]
    assert _plan(16, K, N, 1, dt, 1080)[2] > _plan(16, K, N, 1, dt, 100)[2] == 1
    for blk in (16, 32, 64):
        assert _plan(2048, K, N, 1, dt, 1000, blk=blk)[:2] == (128, 64)
        assert _plan(16, K, N, 1, dt, 1000, blk=blk)[:2] == (16, 64)
    # one 16-row block a column: one slab, nothing to split
    assert _plan(16, 16 * 4, 64 * 4, 1, dt, 4, blk=16)[2] == 1


def _packs(bm):
    """The CSC and the CSR of a (K/bk, N/bn) or stacked (G, ...) block mask,
    as int32 tensors."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    if bm.ndim == 2:
        return [t(a) for a in (*pack_np(bm), *pack_np(bm.T))]
    return [t(a) for a in (*pack_group_mask(bm), *pack_group_mask_rows(bm))]


def _block_mask(rng, G, nkb, nnb):
    """A (G, nkb, nnb) block mask with an empty block column (1) and row
    (2), uneven counts, and a group with no block (G > 1)."""
    bm = rng.random((G, nkb, nnb)) < 0.45
    bm[:, :, 1] = False
    bm[:, 2, :] = False
    bm[:, 0, 0] = True
    bm[:, :, 0] = True
    bm[:, 2, 0] = False
    if G > 1:
        bm[1] = False
    return bm


def _j(t, dt):
    return jnp.asarray(t.float().numpy(), JDT[dt])


def _held(got, want, dt, what):
    """NaN and +-inf in the same places, the finite values within TOL."""
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = got.float()
    assert got.shape == want.shape, what
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    assert torch.equal(torch.isinf(got), torch.isinf(want)), what
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf]), what
    fin = torch.isfinite(want)
    scale = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) <= TOL[dt] * scale, what


BLOCK, M, K, N = 16, 32, 64, 64


def _weights(rng, bm, dt):
    dense = np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)
    w = rng.standard_normal(bm.shape[:1] + (K, N)).astype(np.float32) * dense / np.sqrt(K)
    return torch.from_numpy(w).to(dt)


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_forward_keeps_a_nonfinite_x_to_the_blocks_that_read_it(dt, G):
    """K1/K4's plain versions: an inf in x's columns of the empty block row
    (no column reads them) leaves y finite; a NaN and a -inf in columns of
    block row 0 (read by some columns only) give NaN in the columns whose
    blocks read them and nothing elsewhere, as the reference's kernels in
    interpret mode (``_fwd_call``, ``_g_fwd_call``)."""
    rng = np.random.default_rng(81)
    bm = _block_mask(rng, G, K // BLOCK, N // BLOCK)
    w = _weights(rng, bm, dt)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    x[:, 3, 2 * BLOCK + 5] = np.inf  # block row 2: empty
    x[:, 7, 4] = np.nan              # block row 0
    x[:, 9, 11] = -np.inf            # block row 0
    xt = torch.from_numpy(x).to(dt)
    if G == 1:
        idx, cnt, *_ = _packs(bm[0])
        y = tbsm.block_sparse_matmul_plain(xt[0], w[0], idx, cnt, BLOCK, BLOCK)
        jy = jbsm._fwd_call(_j(xt[0], dt), _j(w[0], dt), jnp.asarray(idx.numpy()),
                            jnp.asarray(cnt.numpy()), M, BLOCK, BLOCK, True)
    else:
        idx, cnt, *_ = _packs(bm)
        y = tbsm.grouped_block_sparse_matmul_plain(xt, w, idx, cnt, BLOCK, BLOCK)
        jy = jbsm._g_fwd_call(_j(xt, dt), _j(w, dt), jnp.asarray(idx.numpy()),
                              jnp.asarray(cnt.numpy()), M, BLOCK, BLOCK, True)
    _held(y, jy, dt, "K1/K4")
    y3 = y.float().reshape(G, M, N)
    reads0 = torch.from_numpy(np.repeat(bm[:, 0], BLOCK, -1))  # (G, N)
    assert bool(torch.isfinite(y3[:, 3]).all())
    assert torch.equal(torch.isnan(y3[:, 7]), reads0)
    assert bool(torch.isfinite(y3[:, 7][~reads0]).all())
    if G > 1:  # the dead expert
        assert not y3[1].any()


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_dgrad_keeps_a_nonfinite_g_to_the_blocks_that_read_it(dt, G):
    """K2/K5's plain versions: an inf in g's columns of the empty block
    column (no K-block row reads them) leaves dx finite; a NaN in a column
    of block column 0 gives NaN only in the dx columns of the K-blocks
    active there, as ``_dx_call`` and ``_g_dx_call`` in interpret mode."""
    rng = np.random.default_rng(83)
    bm = _block_mask(rng, G, K // BLOCK, N // BLOCK)
    w = _weights(rng, bm, dt)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    g[:, 5, BLOCK + 2] = np.inf  # block column 1: empty
    g[:, 6, 3] = np.nan          # block column 0
    gt = torch.from_numpy(g).to(dt)
    if G == 1:
        *_, ridx, rcnt = _packs(bm[0])
        dx = tbsm.block_sparse_dx_plain(gt[0], w[0], ridx, rcnt, BLOCK, BLOCK)
        jdx = jbsm._dx_call(_j(gt[0], dt), _j(w[0], dt), jnp.asarray(ridx.numpy()),
                            jnp.asarray(rcnt.numpy()), M, BLOCK, BLOCK, True, JDT[dt])
    else:
        *_, ridx, rcnt = _packs(bm)
        dx = tbsm.grouped_block_sparse_dx_plain(gt, w, ridx, rcnt, BLOCK, BLOCK)
        jdx = jbsm._g_dx_call(_j(gt, dt), _j(w, dt), jnp.asarray(ridx.numpy()),
                              jnp.asarray(rcnt.numpy()), M, BLOCK, BLOCK, True, JDT[dt])
    _held(dx, jdx, dt, "K2/K5")
    d3 = dx.float().reshape(G, M, K)
    reads0 = torch.from_numpy(np.repeat(bm[:, :, 0], BLOCK, -1))  # (G, K)
    assert bool(torch.isfinite(d3[:, 5]).all())
    assert torch.equal(torch.isnan(d3[:, 6]), reads0)


def _split_case(rng, G, blk, dt, width_pad):
    """x (G, M, K), w (G, K, N) in dt, zero off the blocks, and a stacked
    CSC pack of blk x blk blocks at its width plus ``width_pad`` slots of
    sentinel ids (never read); uneven counts, an empty column, a dead
    expert (G > 1)."""
    Kb, Nb = 192, 192
    bm = _block_mask(rng, G, Kb // blk, Nb // blk)
    bm[:, 3:, 2] = True  # a long column
    if G > 1:
        bm[1] = False  # the dead expert
    dense = np.repeat(np.repeat(bm, blk, 1), blk, 2)
    w = rng.standard_normal((G, Kb, Nb)).astype(np.float32) * dense / np.sqrt(Kb)
    x = rng.standard_normal((G, M, Kb)).astype(np.float32)
    idx, cnt = (np.asarray(a, np.int32) for a in pack_group_mask(bm))
    idx = np.concatenate([idx, np.full(idx.shape[:2] + (width_pad,), 77, np.int32)], -1)
    t = lambda a: torch.from_numpy(a).to(dt)
    return t(x), t(w), torch.from_numpy(idx), torch.from_numpy(cnt), bm


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("blk", [16, 32, 64])
@pytest.mark.parametrize("G", [1, 3])
def test_bs_fwd_split_plain_matches_the_plain_version_and_the_reference(dt, blk, G):
    """Every split count (1 to each slab of the longest list its own split,
    and more: empty parts) within ``matmul_error_bound`` of the unsplit
    plain version (bit for bit unsplit) and within TOL of the reference's
    ``_fwd_call`` / ``_g_fwd_call`` in interpret mode; an empty column and
    a dead expert give zeros, slots past a count (sentinel ids) are never
    read, and at 16-row blocks a 32-row slab walks one block, never two."""
    x, w, idx, cnt, bm = _split_case(np.random.default_rng(87 + blk), G, blk, dt, 2)
    ix, cn = (idx[0], cnt[0]) if G == 1 else (idx, cnt)
    xs, ws = (x[0], w[0]) if G == 1 else (x, w)
    Kb = w.shape[-2]
    if G == 1:
        want = tbsm.block_sparse_matmul_plain(xs, ws, ix, cn, blk, blk)
        absp = tbsm.block_sparse_matmul_plain(xs.float().abs(), ws.float().abs(), ix, cn, blk,
                                              blk)
        ref = jbsm._fwd_call(_j(xs, dt), _j(ws, dt), jnp.asarray(ix.numpy()),
                             jnp.asarray(cn.numpy()), M, blk, blk, True)
    else:
        want = tbsm.grouped_block_sparse_matmul_plain(xs, ws, ix, cn, blk, blk)
        absp = tbsm.grouped_block_sparse_matmul_plain(xs.float().abs(), ws.float().abs(), ix,
                                                      cn, blk, blk)
        ref = jbsm._g_fwd_call(_j(xs, dt), _j(ws, dt), jnp.asarray(ix.numpy()),
                               jnp.asarray(cn.numpy()), M, blk, blk, True)
    _held(want, ref, dt, "unsplit")
    bound = tbsm.matmul_error_bound(want, absp, Kb)
    longest = int(cnt.max()) * -(-blk // tmm.FWD_SLAB)
    for n_split in list(range(1, longest + 1)) + [longest + 3]:
        got = tbsm.block_sparse_matmul_split_plain(xs, ws, ix, cn, blk, blk, n_split)
        assert got.dtype == dt and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        _held(got, ref, dt, f"n_split={n_split}")
        g3 = got.float().reshape(G, M, -1)
        assert not g3[:, :, blk:2 * blk].any()  # the empty block column
        if G > 1:
            assert not g3[1].any()


def test_bs_fwd_split_plain_follows_the_list_order_and_the_slabs():
    """A split covers whole slabs of its column's list in the list's order
    (not K's): a list given in descending order splits into other rows than
    the ascending one, and each split's partial, where the split is a whole
    block (64-row blocks, two slabs a block, n_split = twice the count),
    is that block's product alone: a NaN in x's columns of the block a
    split holds shows in exactly the split's column."""
    blk, Kb, Nb = 64, 256, 128
    w = torch.randn(Kb, Nb)
    x = torch.randn(M, Kb)
    bm = np.zeros((Kb // blk, Nb // blk), bool)
    bm[[0, 2, 3], 0] = True
    bm[1, 1] = True
    idx, cnt = (torch.from_numpy(np.asarray(a, np.int32)) for a in pack_np(bm))
    rev = idx.clone()
    rev[0, :3] = idx[0, :3].flip(0)
    for n_split in (1, 2, 3, 6):
        a = tbsm.block_sparse_matmul_split_plain(x, w, idx, cnt, blk, blk, n_split)
        b = tbsm.block_sparse_matmul_split_plain(x, w, rev, cnt, blk, blk, n_split)
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    # split 2 of 6 on column 0 (3 blocks x 2 slabs) is block idx[0, 1]'s
    # first slab: rows [128, 160) of x
    xn = x.clone()
    xn[0, 2 * blk + 5] = float("nan")
    y = tbsm.block_sparse_matmul_split_plain(xn, w, idx, cnt, blk, blk, 6)
    assert bool(torch.isnan(y[0, :blk]).all()) and bool(torch.isfinite(y[0, blk:]).all())
    assert bool(torch.isfinite(y[1:]).all())


def test_bs_fwd_merge_on_the_cpu_is_the_ordered_sum():
    """``bs_fwd_merge`` on CPU tensors sums the partials in order into out,
    rounds once to out's type and counts no launch."""
    part = torch.randn(3, 2, 16, 32)
    for shape in ((2, 16, 32), (32, 32)):
        if len(shape) == 2:
            p = part[:, :1].reshape(3, 1, 32, 16).contiguous()
            shape = (32, 16)
        else:
            p = part
        out = torch.empty(shape, dtype=BF)
        n0 = tbsm.fwd_merge_launches
        got = tbsm.bs_fwd_merge(p, out)
        assert got is out and tbsm.fwd_merge_launches == n0
        assert torch.equal(out, ((p[0] + p[1]) + p[2]).reshape(shape).to(BF))


def test_the_forward_takes_the_live_blocks_from_the_pack_entry(monkeypatch):
    """The forward path hands K1/K4's plan the pack entry's ``nnz`` -- the
    forward pack's live blocks, never a Top-KAST superset's ``bnnz`` (the
    wgrad's) -- and a bare tuple None (the wrapper then counts every
    slot); the count is never read from the device's ``cnt``."""
    from repro_torch.core.pack import pack_entry

    seen = []
    for name in ("block_sparse_matmul", "grouped_block_sparse_matmul"):
        real = getattr(tbsm, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["live"])
            return _real(*a, **kw)

        monkeypatch.setattr(tbsm, name, spy)
    rng = np.random.default_rng(89)
    m = torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.4, 16, 0), 16, 1))
    m[:16, :16] = True
    sup = m | torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.3, 16, 0), 16, 1))
    e = pack_entry(m, (16, 16), bwd_mask=sup)
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(5, 64)
    block_sparse_linear(x, w, pack=e, block=(128, 16, 16)).sum().backward()
    plain = {k: v for k, v in e.items() if k not in ("bidx", "bcnt", "bnnz")}
    block_sparse_linear(x, w, pack=plain, block=(128, 16, 16)).sum().backward()
    block_sparse_linear(x, w, pack=(e["idx"], e["cnt"]), block=(128, 16, 16)).sum().backward()
    mom = torch.zeros(64, 64)
    block_sparse_linear(x, w, pack=e, block=(128, 16, 16), mom=mom).sum().backward()
    mb = m[None].repeat(3, 1, 1)
    eg = pack_entry(mb, (16, 16), bwd_mask=sup[None].repeat(3, 1, 1))
    wb = torch.randn(3, 64, 64, requires_grad=True)
    grouped_block_sparse_linear(torch.randn(3, 5, 64), wb, pack=eg,
                                block=(128, 16, 16)).sum().backward()
    egp = {k: v for k, v in eg.items() if k not in ("bidx", "bcnt", "bnnz")}
    grouped_block_sparse_linear(torch.randn(3, 5, 64), wb, pack=egp,
                                block=(128, 16, 16)).sum().backward()
    assert seen == [e["nnz"], e["nnz"], None, e["nnz"], eg["nnz"], eg["nnz"]]
    assert e["bnnz"] > e["nnz"] == int(e["cnt"].sum())
    assert eg["bnnz"] > eg["nnz"] == int(eg["cnt"].sum())
