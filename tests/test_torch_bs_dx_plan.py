"""K2/K5's launch plan and its split, on the CPU.

The block-sparse dgrad dx = g @ w^T runs on the GEMM core with the packed
slab map, one CTA a (row tile, column tile) of dx walking its K-block row's
CSR list of active N-blocks, and takes its own plan
(``block_sparse_matmul.dx_plan``: the forward's plan with the dims' roles
swapped -- rows Mp, contraction N, columns K, the grid counted as row tiles x
column tiles x G, a row's walk the mean of the forward pack's live blocks,
the split chosen by the core's ``masked_matmul.fwd_split``): its picks at
the training paths' shapes (given as numbers), the plain version that
follows a split (``block_sparse_dx_split_plain``: f32 partials over whole
slabs of each row's list, summed in split order, rounded once) against the
unsplit plain version and the reference's kernels, and the dgrad's live
count handed down from a pack entry (its ``nnz``, never a superset's
``bnnz``).

The CUDA kernel runs only on a card: tests/test_torch_cuda.py forces every
candidate plan there and holds each against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro_torch.core.pack import pack_group_mask_rows  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear, grouped_block_sparse_linear  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
# CTAs resident per SM of the GEMM core's tiles (the H100 build's occupancy
# of the forward's, whose shapes the dgrad's share; the wrapper reads its
# own from the runtime): 128 x 128 and 16 x 64
CTAS = {(128, BF): 2, (128, F32): 1, (16, BF): 8, (16, F32): 4}
# relative to the largest finite magnitude: f32 the same products summed in
# another order; bf16 one ulp (both round once)
TOL = {F32: 1e-5, BF: 2.0**-7}
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


def _plan(Mp, K, N, G, dt, live, blk=128):
    """K2/K5's plan of g (G, Mp, N) @ w (G, K, N)^T on ``live`` active
    blocks of blk x blk."""
    slots = SMS * CTAS[(16 if Mp <= 64 else 128, dt)]
    return tbsm.dx_plan(Mp, K, N, G, dt, slots, bk=blk, bn=blk, live=live)


# the dgrad shapes of the training paths (g (G, Mp, N), w (G, K, N), rows
# padded), the dtype (attention in bf16, the MLP and the banks in f32), the
# forward pack's live 128 x 128 blocks (the pack entries' nnz at ERK 0.8: a
# dense layer keeps all) and the plan's pick
BS_DX = {
    # danube's seven projections at a 2048-row microbatch: wq/wo's 320
    # CTAs (20 block rows of 16 row tiles; 1.2 waves of 264) walk 19 slabs
    # a row and stay whole; wk/wv's 320 walk 12 and stay whole (the merge
    # of a split's 2048 x 2560 partials costs more than the part wave)
    "danube attn wq": ((2048, 1, 2560, 2560, BF, 96), (128, 128, 1)),
    "danube attn wk": ((2048, 1, 2560, 640, BF, 60), (128, 128, 1)),
    "danube attn wv": ((2048, 1, 2560, 640, BF, 60), (128, 128, 1)),
    "danube attn wo": ((2048, 1, 2560, 2560, BF, 96), (128, 128, 1)),
    # the f32 MLP: wi/wg's dx (2048 x 2560) is 320 CTAs on 132 slots (2.4
    # waves) walking 35 slabs a row: split in 2 (5 waves of 18); wo's dx
    # (2048 x 6912) is 864 CTAs walking 13: whole
    "danube mlp wi": ((2048, 1, 2560, 6912, F32, 178), (128, 128, 2)),
    "danube mlp wg": ((2048, 1, 2560, 6912, F32, 178), (128, 128, 2)),
    "danube mlp wo": ((2048, 1, 6912, 2560, F32, 178), (128, 128, 1)),
    # the update step's one pass over 8192 rows: four times the waves,
    # nothing left idle to split for
    "danube mlp wi, 8192 rows": ((8192, 1, 2560, 6912, F32, 178), (128, 128, 1)),
    # qwen2-moe's 60-expert banks at C 171 -> 256 rows: 1920 CTAs each,
    # whole; at 16 rows (16 x 64 tiles) 1920 CTAs fill the slots alone
    "qwen2-moe bank wi C=256": ((256, 60, 2048, 1408, F32, 1276), (128, 128, 1)),
    "qwen2-moe bank wg C=256": ((256, 60, 2048, 1408, F32, 1276), (128, 128, 1)),
    "qwen2-moe bank wo C=256": ((256, 60, 1408, 2048, F32, 1276), (128, 128, 1)),
    "qwen2-moe bank wi bf16 C=256": ((256, 60, 2048, 1408, BF, 1276), (128, 128, 1)),
    "qwen2-moe bank wo C=16": ((16, 60, 1408, 2048, F32, 1276), (16, 64, 1)),
}


@pytest.mark.parametrize("name", sorted(BS_DX))
def test_bs_dx_plan_at_the_paths_shapes(name):
    """The plan's pick at each training path's dgrad shape, on the forward
    pack's live blocks; every candidate a sweep forces is a built tile of
    the pick's rows, each with a split that walks at least FWD_MIN_SLABS of
    a row's mean slabs, the pick among them."""
    (Mp, G, K, N, dt, live), want = BS_DX[name]
    assert _plan(Mp, K, N, G, dt, live) == want
    slots = SMS * CTAS[(want[0], dt)]
    cands = tbsm.dx_candidates(Mp, K, N, G, dt, slots, bk=128, bn=128, live=live)
    assert want in cands
    assert all((bm, bn) in tmm.FWD_TILES and bm == want[0] for bm, bn, _ in cands)
    mean_slabs = live * 4 // (G * K // 128)
    assert all(n == 1 or n <= mean_slabs // tmm.FWD_MIN_SLABS for *_, n in cands)


@pytest.mark.parametrize("dt", [BF, F32])
def test_bs_dx_plan_follows_the_forward_live_blocks(dt):
    """The walk is the forward pack's live blocks over K/bk rows: a sparser
    pack walks fewer slabs a row, so it never splits more; blocks of 16-64
    rows of w run in 64-column tiles (a tile never spans two block rows),
    16 padded rows in the 16 x 64 tile; one bn = 16 block a row walks one
    slab and has nothing to split."""
    K, N = 2560, 6912
    assert _plan(2048, K, N, 1, dt, 40)[2] <= _plan(2048, K, N, 1, dt, 400)[2]
    assert _plan(2048, N, K, 1, dt, 40)[2] <= _plan(2048, N, K, 1, dt, 400)[2]
    for blk in (16, 32, 64):
        assert _plan(2048, K, N, 1, dt, 1000, blk=blk)[:2] == (128, 64)
        assert _plan(16, K, N, 1, dt, 1000, blk=blk)[:2] == (16, 64)
    assert _plan(2048, 64 * 4, 16 * 4, 1, dt, 4, blk=16)[2] == 1


def _split_case(rng, G, blk, dt, width_pad):
    """g (G, M, N), w (G, K, N) in dt, zero off the blocks, and a stacked
    CSR pack of blk x blk blocks at its width plus ``width_pad`` slots of
    sentinel ids (never read); uneven counts, an empty block row (2) and
    block column (1), a long row, a dead expert (G > 1)."""
    Kb, Nb, M = 192, 192, 32
    bm = rng.random((G, Kb // blk, Nb // blk)) < 0.45
    bm[:, :, 1] = False
    bm[:, 0, 0] = True
    bm[:, 0, 2:] = True  # a long row
    bm[:, 2, :] = False  # the empty block row
    if G > 1:
        bm[1] = False  # the dead expert
    dense = np.repeat(np.repeat(bm, blk, 1), blk, 2)
    w = rng.standard_normal((G, Kb, Nb)).astype(np.float32) * dense / np.sqrt(Nb)
    g = rng.standard_normal((G, M, Nb)).astype(np.float32)
    ridx, rcnt = (np.asarray(a, np.int32) for a in pack_group_mask_rows(bm))
    ridx = np.concatenate([ridx, np.full(ridx.shape[:2] + (width_pad,), 77, np.int32)], -1)
    t = lambda a: torch.from_numpy(a).to(dt)
    return t(g), t(w), torch.from_numpy(ridx), torch.from_numpy(rcnt), M


def _held(got, want, dt, what):
    """NaN and +-inf in the same places, the finite values within TOL."""
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = got.float()
    assert got.shape == want.shape, what
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    assert torch.equal(torch.isinf(got), torch.isinf(want)), what
    fin = torch.isfinite(want)
    scale = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) <= TOL[dt] * scale, what


def _j(t, dt):
    return jnp.asarray(t.float().numpy(), JDT[dt])


@pytest.mark.parametrize("dt", [F32, BF])
@pytest.mark.parametrize("blk", [16, 32, 64])
@pytest.mark.parametrize("G", [1, 3])
def test_bs_dx_split_plain_matches_the_plain_version_and_the_reference(dt, blk, G):
    """Every split count (1 to each slab of the longest list its own split,
    and more: empty parts) within ``matmul_error_bound`` of the unsplit
    plain version (bit for bit unsplit) and within TOL of the reference's
    ``_dx_call`` / ``_g_dx_call`` in interpret mode; the empty block row
    and a dead expert give zeros, and slots past a count (sentinel ids) are
    never read."""
    g, w, ridx, rcnt, M = _split_case(np.random.default_rng(91 + blk), G, blk, dt, 2)
    ri, rc = (ridx[0], rcnt[0]) if G == 1 else (ridx, rcnt)
    gs, ws = (g[0], w[0]) if G == 1 else (g, w)
    Nb = w.shape[-1]
    if G == 1:
        want = tbsm.block_sparse_dx_plain(gs, ws, ri, rc, blk, blk)
        absp = tbsm.block_sparse_dx_plain(gs.float().abs(), ws.float().abs(), ri, rc, blk, blk)
        ref = jbsm._dx_call(_j(gs, dt), _j(ws, dt), jnp.asarray(ri.numpy()),
                            jnp.asarray(rc.numpy()), M, blk, blk, True, JDT[dt])
    else:
        want = tbsm.grouped_block_sparse_dx_plain(gs, ws, ri, rc, blk, blk)
        absp = tbsm.grouped_block_sparse_dx_plain(gs.float().abs(), ws.float().abs(), ri, rc,
                                                  blk, blk)
        ref = jbsm._g_dx_call(_j(gs, dt), _j(ws, dt), jnp.asarray(ri.numpy()),
                              jnp.asarray(rc.numpy()), M, blk, blk, True, JDT[dt])
    _held(want, ref, dt, "unsplit")
    bound = tbsm.matmul_error_bound(want, absp, Nb)
    longest = int(rcnt.max()) * -(-blk // tmm.FWD_SLAB)
    for n_split in list(range(1, longest + 1)) + [longest + 3]:
        got = tbsm.block_sparse_dx_split_plain(gs, ws, ri, rc, blk, blk, n_split)
        assert got.dtype == dt and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        _held(got, ref, dt, f"n_split={n_split}")
        d3 = got.float().reshape(G, M, -1)
        assert not d3[:, :, 2 * blk:3 * blk].any()  # the empty block row
        if G > 1:
            assert not d3[1].any()  # the dead expert


def test_bs_dx_split_plain_follows_the_list_order_and_the_slabs():
    """A split covers whole slabs of its row's list in the list's order
    (not N's): a list given in descending order splits into other columns
    of g than the ascending one, and each split's partial, where the split
    is a whole block (64-column blocks, two slabs a block, n_split = twice
    the count), is that block's product alone: a NaN in g's columns of the
    block a split holds shows in exactly that K-block row's columns of dx."""
    blk, Kb, Nb, M = 64, 128, 256, 32
    w = torch.randn(Kb, Nb)
    g = torch.randn(M, Nb)
    bm = np.zeros((Kb // blk, Nb // blk), bool)
    bm[0, [0, 2, 3]] = True
    bm[1, 1] = True
    ridx, rcnt = (torch.from_numpy(np.asarray(a, np.int32)[0])
                  for a in pack_group_mask_rows(bm[None]))
    rev = ridx.clone()
    rev[0, :3] = ridx[0, :3].flip(0)
    for n_split in (1, 2, 3, 6):
        a = tbsm.block_sparse_dx_split_plain(g, w, ridx, rcnt, blk, blk, n_split)
        b = tbsm.block_sparse_dx_split_plain(g, w, rev, rcnt, blk, blk, n_split)
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    # split 2 of 6 on row 0 (3 blocks x 2 slabs) is block ridx[0, 1]'s
    # first slab: columns [128, 160) of g
    gn = g.clone()
    gn[0, 2 * blk + 5] = float("nan")
    dx = tbsm.block_sparse_dx_split_plain(gn, w, ridx, rcnt, blk, blk, 6)
    assert bool(torch.isnan(dx[0, :blk]).all()) and bool(torch.isfinite(dx[0, blk:]).all())
    assert bool(torch.isfinite(dx[1:]).all())


def test_bs_dx_merge_on_the_cpu_is_the_ordered_sum():
    """``bs_dx_merge`` on CPU tensors sums the partials in order into dx,
    rounds once to dx's type and counts no launch."""
    part = torch.randn(3, 2, 16, 32)
    for p, shape in ((part, (2, 16, 32)), (part[:, :1].contiguous(), (16, 32))):
        out = torch.empty(shape, dtype=BF)
        n0 = tbsm.dx_merge_launches
        got = tbsm.bs_dx_merge(p, out)
        assert got is out and tbsm.dx_merge_launches == n0
        assert torch.equal(out, ((p[0] + p[1]) + p[2]).reshape(shape).to(BF))


def test_the_dgrad_takes_the_live_blocks_from_the_pack_entry(monkeypatch):
    """The backward hands K2/K5's plan the pack entry's ``nnz`` -- the
    forward pack's live blocks, which the CSR lists, never a Top-KAST
    superset's ``bnnz`` (the wgrad's) -- in the plain, Top-KAST and fused
    forms, and a bare tuple None (the wrapper then counts every slot); the
    count is never read from the device's ``rcnt``."""
    from repro_torch.core.pack import pack_entry

    seen = []
    for name in ("block_sparse_dx", "grouped_block_sparse_dx"):
        real = getattr(tbsm, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["live"])
            return _real(*a, **kw)

        monkeypatch.setattr(tbsm, name, spy)
    rng = np.random.default_rng(93)
    m = torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.4, 16, 0), 16, 1))
    m[:16, :16] = True
    sup = m | torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.3, 16, 0), 16, 1))
    e = pack_entry(m, (16, 16), bwd_mask=sup)
    x = torch.randn(5, 64, requires_grad=True)
    w = torch.randn(64, 64)
    block_sparse_linear(x, w, pack=e, block=(128, 16, 16)).sum().backward()
    plain = {k: v for k, v in e.items() if k not in ("bidx", "bcnt", "bnnz")}
    block_sparse_linear(x, w, pack=plain, block=(128, 16, 16)).sum().backward()
    block_sparse_linear(x, w, pack=(e["idx"], e["cnt"]), block=(128, 16, 16)).sum().backward()
    block_sparse_linear(x, w, pack=e, block=(128, 16, 16), mom=torch.zeros(64, 64)).sum().backward()
    eg = pack_entry(m[None].repeat(3, 1, 1), (16, 16), bwd_mask=sup[None].repeat(3, 1, 1))
    xg = torch.randn(3, 5, 64, requires_grad=True)
    wg = torch.randn(3, 64, 64)
    grouped_block_sparse_linear(xg, wg, pack=eg, block=(128, 16, 16)).sum().backward()
    egp = {k: v for k, v in eg.items() if k not in ("bidx", "bcnt", "bnnz")}
    grouped_block_sparse_linear(xg, wg, pack=egp, block=(128, 16, 16)).sum().backward()
    assert seen == [e["nnz"], e["nnz"], None, e["nnz"], eg["nnz"], eg["nnz"]]
    assert e["bnnz"] > e["nnz"] == int(e["rcnt"].sum())
    assert eg["bnnz"] > eg["nnz"] == int(eg["rcnt"].sum())
