"""K3/K6's launch plan and its split, and the plain K1-K6 on the pack, on
the CPU.

The block-sparse wgrad runs on the GEMM core of the masked kernels, one CTA
a live block of its pack, and takes its own plan
(``block_sparse_matmul.dw_plan``: rows K, contraction M, columns N, the
smallest built wgrad tile that holds a block, the grid counted as the
pack's live blocks, the split chosen by the core's
``masked_matmul.fwd_split``):
its picks at the training paths' wgrad shapes (given as numbers), the plain
version that follows a split (``block_sparse_dw_split_plain``: f32
partials over whole M slabs, summed in split order, selected onto the pack,
rounded once) and the merge of the packed partials (``bs_dw_merge_plain``)
against the unsplit plain version.

The plain K1-K6 select the pack's blocks: an inf in an inactive block of w,
or a wgrad sum off the superset, never reaches the output, and dw is +0.0
off the superset, as the reference's kernels (``_fwd_call``, ``_dx_call``,
``_dw_call`` with ``_scatter_packed_dw`` and their grouped twins) in
interpret mode.

The CUDA kernel runs only on a card: tests/test_torch_cuda.py forces every
candidate plan there and holds each against these plain versions.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro_torch.core.pack import pack_group_mask, pack_group_mask_rows, pack_np  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear, grouped_block_sparse_linear  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
# CTAs resident per SM of the wgrad's tiles (the H100 build's occupancy, as
# the masked wgrad's; the wrapper reads it from the runtime)
CTAS = {BF: 2, F32: 1}
BLOCK = 16
# relative to the largest finite magnitude: f32 the same products summed in
# another order; bf16 one ulp (both round once)
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


def _bs_plan(M, K, N, G, dt, live, bn=128):
    """K3/K6's plan of x (G, M, K)^T @ g (G, M, N) on ``live`` blocks of
    ``bn`` columns: rows K, contraction M, columns N."""
    return tbsm.dw_plan(M, K, N, G, dt, SMS * CTAS[dt], bn=bn, live=live)


# the wgrad shapes of the training paths (one microbatch's M rows, padded),
# dw (G, K, N) and its dtype (attention in bf16, the MLP and the banks in
# f32), the live blocks of the 128 x 128 Top-KAST superset at ERK 0.8 (the
# pack entries' bnnz: ERK density times the blocks, plus 10% of them; a
# dense layer keeps all), and the plan's pick
BS_DW = {
    # 70 CTAs on 264 slots: two halves of 32 slabs fill one wave (four
    # quarters need a second)
    "danube attn wk/wv": ((2048, 1, 2560, 640, BF, 70), (128, 128, 2)),
    # 63: four quarters of 16 slabs fit one wave
    "danube attn wk/wv, 63 blocks": ((2048, 1, 2560, 640, BF, 63), (128, 128, 4)),
    # 136 CTAs: split, 272 need a second wave for 8 of them (no gain)
    "danube attn wq/wo": ((2048, 1, 2560, 2560, BF, 136), (128, 128, 1)),
    # 286 CTAs on 132 slots: 3 waves of 64 slabs against 9 of 16
    "danube mlp wi/wg": ((2048, 1, 2560, 6912, F32, 286), (128, 128, 4)),
    "danube mlp wo": ((2048, 1, 6912, 2560, F32, 286), (128, 128, 4)),
    # 264 CTAs: two full waves, nothing to gain
    "danube mlp wi, 264 blocks": ((2048, 1, 2560, 6912, F32, 264), (128, 128, 1)),
    # the update step's one pass over the batch's 8192 rows
    "danube mlp wi, 8192 rows": ((8192, 1, 2560, 6912, F32, 286), (128, 128, 4)),
    # qwen2-moe's dense attention and shared MLP (every block live)
    "qwen2-moe attn": ((2048, 1, 2048, 2048, BF, 256), (128, 128, 1)),
    "qwen2-moe shared wi/wg": ((2048, 1, 2048, 5632, F32, 704), (128, 128, 1)),
    "qwen2-moe shared wo": ((2048, 1, 5632, 2048, F32, 704), (128, 128, 1)),
    # the 60-expert banks at C = 171 -> 256 rows and at 16 (one slab)
    "qwen2-moe bank wi f32 C=256": ((256, 60, 2048, 1408, F32, 2332), (128, 128, 1)),
    "qwen2-moe bank wo f32 C=256": ((256, 60, 1408, 2048, F32, 2332), (128, 128, 1)),
    "qwen2-moe bank wi bf16 C=256": ((256, 60, 2048, 1408, BF, 2332), (128, 128, 1)),
    "qwen2-moe bank wi f32 C=16": ((16, 60, 2048, 1408, F32, 2332), (128, 128, 1)),
    "qwen2-moe bank wo bf16 C=16": ((16, 60, 1408, 2048, BF, 2332), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(BS_DW))
def test_bs_dw_plan_at_the_training_shapes(name):
    """The plan's pick at each training path's wgrad shape, counting the
    live blocks; a one-slab walk keeps the 128-column tile that holds its
    block (no 128 x 64 as the masked wgrad's); every candidate a sweep
    forces is a built wgrad tile that holds the block, the pick among
    them."""
    (M, G, K, N, dt, live), want = BS_DW[name]
    assert _bs_plan(M, K, N, G, dt, live) == want
    cands = tbsm.dw_candidates(M, K, N, G, dt, SMS * CTAS[dt], bn=128, live=live)
    assert want in cands and all((bm, bn) in tmm.DW_TILES and bn == 128 for bm, bn, _ in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_bs_dw_plan_follows_the_live_blocks(dt):
    """The grid is the live blocks, not the dense tile count: danube's MLP
    shape splits on its 286 superset blocks and stays whole on all 1080
    (full waves), the wrapper's default without a count being every slot;
    a handful of blocks splits further, every split walking at least two
    slabs.  Blocks of 16-64 columns run in the 128 x 64 tile, wider ones in
    128 x 128, and only tiles that hold the block are candidates, each
    with every split of ``FWD_SPLITS`` that walks two slabs."""
    K, N = 2560, 6912
    slots = SMS * CTAS[dt]
    assert _bs_plan(2048, K, N, 1, dt, 286)[2] > 1
    assert _bs_plan(2048, K, N, 1, dt, 1080)[2] == 1
    assert _bs_plan(2048, K, N, 1, dt, None) == _bs_plan(2048, K, N, 1, dt, 1080)
    assert _bs_plan(2048, K, N, 1, dt, 40)[2] > _bs_plan(2048, K, N, 1, dt, 286)[2]
    assert _bs_plan(64, K, N, 1, dt, 40)[2] == 1  # two slabs: one split would walk one
    assert _bs_plan(16, K, N, 1, dt, 40)[2] == 1  # one slab: nothing to split
    for bn, tile in ((16, (128, 64)), (32, (128, 64)), (64, (128, 64)), (80, (128, 128)),
                     (128, (128, 128))):
        assert tbsm.dw_tile(bn) == tile
        assert _bs_plan(2048, K, N, 1, dt, 40, bn=bn)[:2] == tile
        cands = tbsm.dw_candidates(2048, K, N, 1, dt, slots, bn=bn, live=40)
        assert {(bm, b) for bm, b, _ in cands} == {t for t in tmm.DW_TILES if t[1] >= bn}
        assert {n for *_, n in cands} == set(tmm.FWD_SPLITS)


def _packs(bm):
    """The CSC and the CSR of a (K/bk, N/bn) or stacked (G, ...) block mask,
    as int32 tensors."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    if bm.ndim == 2:
        return [t(a) for a in (*pack_np(bm), *pack_np(bm.T))]
    return [t(a) for a in (*pack_group_mask(bm), *pack_group_mask_rows(bm))]


def _block_mask(rng, G, K, N):
    """A (G, K/16, N/16) block mask with an empty block column and row and a
    group with no block (G > 1)."""
    bm = rng.random((G, K // BLOCK, N // BLOCK)) < 0.45
    bm[:, :, 1] = False
    bm[:, 2, :] = False
    bm[:, 0, 0] = True
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


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_forward_and_dgrad_skip_inactive_blocks(dt, G):
    """K1/K4 and K2/K5's plain versions select w onto the pack: an inf and a
    NaN in inactive blocks of w give no NaN, as the reference's kernels,
    which never read those blocks (``_fwd_call``, ``_dx_call`` and their
    grouped twins in interpret mode); the output is finite."""
    M, K, N = 32, 64, 64
    rng = np.random.default_rng(61)
    bm = _block_mask(rng, G, K, N)
    dense = np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)
    w = rng.standard_normal((G, K, N)).astype(np.float32) * dense / np.sqrt(K)
    w[0, 2 * BLOCK + 3, 5] = np.inf  # in the empty block row
    w[G - 1, 7, BLOCK + 2] = np.nan  # in the empty block column
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dt)
    xt, wt, gt = t(x), t(w), t(g)
    if G == 1:
        idx, cnt, ridx, rcnt = _packs(bm[0])
        y = tbsm.block_sparse_matmul_plain(xt[0], wt[0], idx, cnt, BLOCK, BLOCK)
        dx = tbsm.block_sparse_dx_plain(gt[0], wt[0], ridx, rcnt, BLOCK, BLOCK)
        jy = jbsm._fwd_call(_j(xt[0], dt), _j(wt[0], dt), jnp.asarray(idx.numpy()),
                            jnp.asarray(cnt.numpy()), M, BLOCK, BLOCK, True)
        jdx = jbsm._dx_call(_j(gt[0], dt), _j(wt[0], dt), jnp.asarray(ridx.numpy()),
                            jnp.asarray(rcnt.numpy()), M, BLOCK, BLOCK, True, JDT[dt])
    else:
        idx, cnt, ridx, rcnt = _packs(bm)
        y = tbsm.grouped_block_sparse_matmul_plain(xt, wt, idx, cnt, BLOCK, BLOCK)
        dx = tbsm.grouped_block_sparse_dx_plain(gt, wt, ridx, rcnt, BLOCK, BLOCK)
        jy = jbsm._g_fwd_call(_j(xt, dt), _j(wt, dt), jnp.asarray(idx.numpy()),
                              jnp.asarray(cnt.numpy()), M, BLOCK, BLOCK, True)
        jdx = jbsm._g_dx_call(_j(gt, dt), _j(wt, dt), jnp.asarray(ridx.numpy()),
                              jnp.asarray(rcnt.numpy()), M, BLOCK, BLOCK, True, JDT[dt])
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(dx.float()).all())
    _held(y, jy, dt, "K1/K4")
    _held(dx, jdx, dt, "K2/K5")


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_wgrad_is_zero_off_the_superset(dt, G):
    """K3/K6's plain versions select the sum onto the pack: an inf in x
    (row 5, column 5: dw's row 5 is +-inf on the pack's blocks) and a NaN
    in g (dw's column 50) give +0.0 off the pack, never NaN or -0.0, and
    +-inf and NaN on it in the reference's places (``_dw_call`` +
    ``_scatter_packed_dw``, ``_g_dw_call`` + its vmap, in interpret mode);
    a group with no block is all +0.0."""
    M, K, N = 32, 64, 64
    rng = np.random.default_rng(67)
    bm = _block_mask(rng, G, K, N)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    x[:, 5, 5] = np.inf
    g[:, 9, 50] = np.nan
    t = lambda a: torch.from_numpy(a).to(dt)
    xt, gt = t(x), t(g)
    nkb = K // BLOCK
    if G == 1:
        idx, cnt, *_ = _packs(bm[0])
        dw = tbsm.block_sparse_dw_plain(xt[0], gt[0], idx, cnt, BLOCK, BLOCK)
        ji, jc = jnp.asarray(idx.numpy()), jnp.asarray(cnt.numpy())
        packed = jbsm._dw_call(_j(xt[0], dt), _j(gt[0], dt), ji, jc, M, BLOCK, BLOCK, True)
        want = jbsm._scatter_packed_dw(packed, ji, jc, nkb, BLOCK, BLOCK, JDT[dt])
    else:
        idx, cnt, *_ = _packs(bm)
        dw = tbsm.grouped_block_sparse_dw_plain(xt, gt, idx, cnt, BLOCK, BLOCK)
        ji, jc = jnp.asarray(idx.numpy()), jnp.asarray(cnt.numpy())
        packed = jbsm._g_dw_call(_j(xt, dt), _j(gt, dt), ji, jc, M, BLOCK, BLOCK, True)
        want = jax.vmap(lambda p, i, c: jbsm._scatter_packed_dw(
            p, i, c, nkb, BLOCK, BLOCK, JDT[dt]))(packed, ji, jc)
    _held(dw, want, dt, "K3/K6")
    live = torch.from_numpy(np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)).reshape(dw.shape)
    off = dw.float()[~live]
    assert not off.any() and not bool(torch.signbit(off).any())
    dwr, lv = dw.float().reshape(-1, K, N), live.reshape(-1, K, N)
    assert bool(torch.isinf(dwr[:, 5][lv[:, 5]]).any()) and bool(torch.isnan(dwr).any())
    if G > 1:
        assert not dw[1].float().any()


def _wgrad_inputs(rng, G, M, K, N, dt, rows):
    """x (G, M, K), g (G, M, N) in dt (rows past ``rows`` zero: the
    wrapper's padding), a stacked superset pack at a width of its own."""
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = (rng.standard_normal((G, M, N)) / np.sqrt(M)).astype(np.float32)
    x[:, rows:] = 0.0
    g[:, rows:] = 0.0
    bm = _block_mask(rng, G, K, N)
    t = lambda a: torch.from_numpy(a).to(dt)
    return t(x), t(g), bm


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("shape", [(1, 48, 64, 80, 40), (1, 96, 48, 64, 96), (3, 80, 48, 96, 71)])
def test_bs_dw_split_plain_and_merge_match_the_plain_version(dt, shape):
    """Every split count (1 to every M slab its own split) within
    ``matmul_error_bound`` of the unsplit plain version (bit for bit
    unsplit), +0.0 off the pack, 2-D and grouped; the packed partials
    merged by ``bs_dw_merge`` (on CPU tensors ``bs_dw_merge_plain``, no
    launch counted) are the split plain version bit for bit on the pack and
    leave every element off it as it was."""
    G, M, K, N, rows = shape
    x, g, bm = _wgrad_inputs(np.random.default_rng(71), G, M, K, N, dt, rows)
    idx, cnt, *_ = _packs(bm[0] if G == 1 else bm)
    if G == 1:
        x, g = x[0], g[0]
        want = tbsm.block_sparse_dw_plain(x, g, idx, cnt, BLOCK, BLOCK)
        absp = tbsm.block_sparse_dw_plain(x.float().abs(), g.float().abs(), idx, cnt, BLOCK,
                                          BLOCK)
    else:
        want = tbsm.grouped_block_sparse_dw_plain(x, g, idx, cnt, BLOCK, BLOCK)
        absp = tbsm.grouped_block_sparse_dw_plain(x.float().abs(), g.float().abs(), idx, cnt,
                                                  BLOCK, BLOCK)
    bound = tbsm.matmul_error_bound(want, absp, M)
    live = torch.from_numpy(np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)).reshape(want.shape)
    ix = idx[None] if G == 1 else idx
    for n_split in range(1, -(-M // tmm.FWD_SLAB) + 1):
        got = tbsm.block_sparse_dw_split_plain(x, g, idx, cnt, BLOCK, BLOCK, n_split)
        assert got.dtype == dt and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        assert not got[~live].any()
        # the kernel's packed partials (n_split, G, N/bn, width, bk, bn)
        xs, gs = x.float().reshape(G, M, K), g.float().reshape(G, M, N)
        part = torch.stack([
            (xs[:, a:b].transpose(1, 2) @ gs[:, a:b]).reshape(
                G, K // BLOCK, BLOCK, N // BLOCK, BLOCK)[
                torch.arange(G)[:, None, None], ix.long(), :,
                torch.arange(N // BLOCK)[None, :, None]]
            for a, b in tmm.fwd_split_ranges(M, n_split)])
        sentinel = torch.full(want.shape, 7.0, dtype=dt)
        n0 = tbsm.dw_merge_launches
        merged = tbsm.bs_dw_merge(part, idx, cnt, sentinel.clone())
        assert tbsm.dw_merge_launches == n0
        assert torch.equal(merged[live], got[live]), n_split
        assert bool((merged[~live] == 7.0).all()), n_split


def test_the_backward_takes_the_live_blocks_from_the_pack_entry(monkeypatch):
    """The training path hands K3/K6's plan the pack entry's host int --
    ``bnnz`` for a superset, ``nnz`` else -- and a bare tuple None (the
    wrapper then counts every slot); the count is never read from the
    device's ``cnt``/``bcnt``."""
    from repro_torch.core.pack import pack_entry

    seen = []
    for name in ("block_sparse_dw", "grouped_block_sparse_dw"):
        real = getattr(tbsm, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["live"])
            return _real(*a, **kw)

        monkeypatch.setattr(tbsm, name, spy)
    rng = np.random.default_rng(73)
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
    mb = m[None].repeat(3, 1, 1)
    eg = pack_entry(mb, (16, 16), bwd_mask=sup[None].repeat(3, 1, 1))
    wb = torch.randn(3, 64, 64, requires_grad=True)
    grouped_block_sparse_linear(torch.randn(3, 5, 64), wb, pack=eg,
                                block=(128, 16, 16)).sum().backward()
    assert seen == [e["bnnz"], e["nnz"], None, eg["bnnz"]]
    assert e["bnnz"] == int(e["bcnt"].sum()) > e["nnz"] == int(e["cnt"].sum())
