"""K7/K8's launch plan and its split, on the CPU.

The block-sparse fused SGD wgrad runs K3/K6's kernel on the GEMM core (one
CTA a live block of the wgrad pack) with the momentum epilogue at the store,
and takes K3/K6's plan (``block_sparse_matmul.dw_plan``: rows K,
contraction M, columns N, the smallest built wgrad tile that holds a block,
the grid counted as the pack's live blocks) on the fused kernel's own
resident CTAs: its picks at the training paths' shapes (given as numbers),
the plain version that follows a split
(``block_sparse_dw_fused_split_plain``: f32 partials over whole M slabs,
summed in split order, then the epilogue -- the momentum, sr -- once on the
pack's blocks) and the merge of the packed partials with the same epilogue
(``bs_dw_fused_merge_plain``) against the unsplit plain version within
``fused_error_bound`` (bit for bit unsplit) and against the reference's
Pallas kernels (``_dw_fused_call``, ``_g_dw_fused_call`` with
``_scatter_packed_dw``) in interpret mode, the sr ids equal; padded slots
and a group with no block +0.0, a dead expert's live blocks mu * mom + wd *
w, and an inf in w outside the superset nowhere in the output.

The CUDA kernel runs only on a card: tests/test_torch_cuda.py forces every
candidate plan there and holds each against these plain versions.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro_torch.core.pack import pack_entry, pack_group_mask  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear, grouped_block_sparse_linear  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
# CTAs resident per SM of the fused wgrad's tiles (the H100 build's
# occupancy, as K3/K6's: the launch bound holds bf16 at 2, f32's shared
# ring at 1; the wrapper reads it from the runtime)
CTAS = {BF: 2, F32: 1}
MU, WD, SEED = 0.9, 1e-4, 0x9E3779B9  # a seed with the sign bit set
BLOCK = 16
JDT = {F32: jnp.float32, BF: jnp.bfloat16}


def _plan(M, K, N, G, dt, live, bn=128):
    """K7/K8's plan of x (G, M, K)^T @ g (G, M, N) on ``live`` superset
    blocks of ``bn`` columns: rows K, contraction M, columns N."""
    return tbsm.dw_plan(M, K, N, G, dt, SMS * CTAS[dt], bn=bn, live=live)


# the fused wgrad shapes of the training paths (rows the microbatch's M,
# padded), m_new (G, K, N) in its dtype (attention in bf16, the MLP, the
# shared MLP and the banks in f32), the live blocks of the 128 x 128
# Top-KAST superset (the pack entries' bnnz; qwen2-moe's shared MLP and
# attention are dense), and the plan's pick
BS_FUSED = {
    # 286 CTAs on 132 slots: 3 waves of 64 slabs against 9 of 16
    "danube mlp wi/wg f32 M=2048": ((2048, 1, 2560, 6912, F32, 286), (128, 128, 4)),
    "danube mlp wo f32 M=2048": ((2048, 1, 6912, 2560, F32, 286), (128, 128, 4)),
    # 136 CTAs on 264 slots: a split of 2 needs a second wave for 8 of them
    "danube attn wq bf16 M=2048": ((2048, 1, 2560, 2560, BF, 136), (128, 128, 1)),
    # one slab: nothing to split
    "danube mlp wi/wg f32 M=16": ((16, 1, 2560, 6912, F32, 286), (128, 128, 1)),
    "danube mlp wo f32 M=16": ((16, 1, 6912, 2560, F32, 286), (128, 128, 1)),
    "danube attn wq bf16 M=16": ((16, 1, 2560, 2560, BF, 136), (128, 128, 1)),
    # qwen2-moe's dense shared MLP and attention (every block live)
    "qwen2-moe shared wi/wg f32": ((2048, 1, 2048, 5632, F32, 704), (128, 128, 1)),
    "qwen2-moe shared wo f32": ((2048, 1, 5632, 2048, F32, 704), (128, 128, 1)),
    "qwen2-moe attn wq bf16": ((2048, 1, 2048, 2048, BF, 256), (128, 128, 1)),
    # layer 0's 60-expert bank supersets at C = 171 -> 256 rows and at 16
    "qwen2-moe bank wi f32 C=256": ((256, 60, 2048, 1408, F32, 2332), (128, 128, 1)),
    "qwen2-moe bank wo f32 C=256": ((256, 60, 1408, 2048, F32, 2332), (128, 128, 1)),
    "qwen2-moe bank wi f32 C=16": ((16, 60, 2048, 1408, F32, 2332), (128, 128, 1)),
}


@pytest.mark.parametrize("name", sorted(BS_FUSED))
def test_bs_fused_plan_at_the_training_shapes(name):
    """The fused wgrad's pick at each training path's shape, counting the
    superset's live blocks: K3/K6's plan on the same slots (the same walk;
    only the store and the merge's epilogue differ); every candidate a
    sweep forces is a built wgrad tile that holds the block, the pick among
    them."""
    (M, G, K, N, dt, live), want = BS_FUSED[name]
    assert _plan(M, K, N, G, dt, live) == want
    cands = tbsm.dw_candidates(M, K, N, G, dt, SMS * CTAS[dt], bn=128, live=live)
    assert want in cands and all((bm, bn) in tmm.DW_TILES and bn == 128 for bm, bn, _ in cands)


def test_bs_fused_plan_reads_the_fused_kernels_slots(monkeypatch):
    """``_dw_plan_for`` with a mom dtype reads the resident CTAs of the
    fused entry of that instantiation (``block_sparse_dw_fused_info_<T>_<mom
    type>_<output type>``), without one K3/K6's; the slots decide the
    split: danube's f32 MLP on 286 blocks splits in 4 on one CTA an SM and
    in 8 on two (more slots, a deeper split to fill them)."""
    seen = []

    def info(name, lib, tm, tn):
        seen.append((name, lib, tm, tn))
        return {"ctas_per_sm": 2 if "fused" in name else 1}

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(tmm, "launch_info", info)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda _: Props)
    tbsm._dw_plan_for.cache_clear()
    try:
        k3 = tbsm._dw_plan_for(2048, 2560, 6912, 1, F32, 128, 286, 0)
        k7 = tbsm._dw_plan_for(2048, 2560, 6912, 1, F32, 128, 286, 0, BF, F32)
        tbsm._dw_plan_for(16, 64, 96, 1, BF, 16, 5, 0, F32, None)
    finally:
        tbsm._dw_plan_for.cache_clear()
    assert seen == [("block_sparse_dw_info_f32", "block_sparse_bwd", 128, 128),
                    ("block_sparse_dw_fused_info_f32_bf16_f32", "block_sparse_bwd", 128, 128),
                    ("block_sparse_dw_fused_info_bf16_f32_bf16", "block_sparse_bwd", 128, 64)]
    assert k3 == (128, 128, 4) and k7 == (128, 128, 8)


def _block_mask(rng, G, nkb, nnb):
    """A (G, nkb, nnb) superset block mask: column 0 full but its last row
    (it sets the shared width), column 1 empty (every slot of it padded),
    the rest at 45%; with G > 1 group 1 has no block."""
    bm = rng.random((G, nkb, nnb)) < 0.45
    bm[:, :, 0] = True
    bm[:, -1, 0] = False
    bm[:, :, 1] = False
    if G > 1:
        bm[1] = False
    return bm


def _problem(rng, G, M, K, N, dt, mdt, rows=None):
    """x (G, M, K), g (G, M, N) (rows past ``rows`` zero: the wrapper's
    padding) and w in dt, mom in mdt (w and mom over every block, the
    superset's and the rest), the stacked superset CSC and its dense bool
    (G, K, N), from numpy."""
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = (rng.standard_normal((G, M, N)) / np.sqrt(M)).astype(np.float32)
    if rows is not None:
        x[:, rows:] = 0.0
        g[:, rows:] = 0.0
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    mom = (0.1 * rng.standard_normal((G, K, N))).astype(np.float32)
    bm = _block_mask(rng, G, K // BLOCK, N // BLOCK)
    idx, cnt = (torch.from_numpy(a) for a in pack_group_mask(bm))
    live = torch.from_numpy(np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2))
    t = lambda a, d: torch.from_numpy(a).to(d)
    return t(x, dt), t(g, dt), t(w, dt), t(mom, mdt), idx, cnt, live


def _squeeze(G, *ts):
    return tuple(t[0] for t in ts) if G == 1 else ts


def _kw(sr):
    return dict(mu=MU, wd=WD, sr=sr, bk=BLOCK, bn=BLOCK)


def _packed(x, g, idx, n_split, M, K, N):
    """The kernel's packed f32 partials (n_split, G, N/bn, width, bk, bn):
    split s's x^T @ g over its M slabs at every slot of the pack (padded
    slots hold block 0's, which the merge never reads)."""
    G = 1 if x.dim() == 2 else x.shape[0]
    xs, gs = x.float().reshape(G, M, K), g.float().reshape(G, M, N)
    ix = idx.reshape(G, N // BLOCK, -1).long()
    return torch.stack([
        (xs[:, a:b].transpose(1, 2) @ gs[:, a:b]).reshape(
            G, K // BLOCK, BLOCK, N // BLOCK, BLOCK)[
            torch.arange(G)[:, None, None], ix, :, torch.arange(N // BLOCK)[None, :, None]]
        for a, b in tmm.fwd_split_ranges(M, n_split)])


@pytest.mark.parametrize("types", [(F32, BF), (BF, BF), (F32, F32)])
@pytest.mark.parametrize("shape", [(1, 48, 64, 80, 40), (1, 96, 48, 64, 96), (3, 80, 48, 96, 71)])
def test_bs_dw_fused_split_plain_and_merge_match_the_plain_version(types, shape):
    """Every split count (1 to every M slab its own split), 2-D (K7) and
    grouped (K8): sr off within ``fused_error_bound`` of the unsplit plain
    version (bit for bit unsplit), +0.0 off the superset and for the group
    with no block; sr on bit for bit ``sr_to_bf16`` of its own f32 m_new,
    on the bf16 grid.  The packed partials merged by ``bs_dw_fused_merge``
    (on CPU tensors ``bs_dw_fused_merge_plain``, no launch counted) are the
    split plain version bit for bit on the superset, sr off and on, and
    leave every element off it as it was."""
    dt, mdt = types
    G, M, K, N, rows = shape
    x, g, w, mom, idx, cnt, live = _problem(np.random.default_rng(71), G, M, K, N, dt, mdt,
                                            rows)
    x, g, w, mom, idx, cnt, live = _squeeze(G, x, g, w, mom, idx, cnt, live)
    plain = tbsm.block_sparse_dw_fused_plain if G == 1 else \
        tbsm.grouped_block_sparse_dw_fused_plain
    want = plain(x, g, idx, cnt, w, mom, SEED, **_kw(False))
    xt = x.float().transpose(-1, -2)
    acc, absp = xt @ g.float(), xt.abs() @ g.float().abs()
    bound = tmm.fused_error_bound(want, absp, M, MU, WD, mom, w, acc, live)
    gid = tmm._gid(K, N, "cpu", G=G if G > 1 else None)
    for n_split in range(1, -(-M // tmm.FWD_SLAB) + 1):
        got = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                     **_kw(False))
        assert got.dtype == dt and got.shape == want.shape
        if n_split == 1:
            assert torch.equal(got, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all()), n_split
        off = got.float()[~live]
        assert not off.any() and not bool(torch.signbit(off).any()), n_split
        if G > 1:
            assert not got[1].float().any() and not bool(torch.signbit(got[1].float()).any())
        raw = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                     out_dtype=F32, **_kw(False))
        sr = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                    **_kw(True))
        assert torch.equal(sr, tmm.sr_to_bf16(raw, SEED, gid).to(dt)), n_split
        assert torch.equal(sr.float(), sr.to(BF).float())
        part = _packed(x, g, idx, n_split, M, K, N)
        n0 = tbsm.dw_fused_merge_launches
        for s_r, expect in ((False, got), (True, sr)):
            sentinel = torch.full(want.shape, 7.0, dtype=dt)
            merged = tbsm.bs_dw_fused_merge(part, idx, cnt, w, mom, sentinel, SEED, mu=MU,
                                            wd=WD, sr=s_r)
            assert merged is sentinel
            assert torch.equal(merged[live], expect[live]), (n_split, s_r)
            assert bool((merged[~live] == 7.0).all()), (n_split, s_r)
        assert tbsm.dw_fused_merge_launches == n0


def _exact(rng, shape, scale):
    """Values on a coarse grid (multiples of 2**-4 * scale below 2 * scale):
    with mu 0.5 and wd 2**-10 every f32 operation of m_new is exact on both
    sides, whatever the order of the sums."""
    return (rng.integers(-24, 25, shape) * 2.0**-4 * scale).astype(np.float32)


def _reference(x, g, idx, cnt, w, mom, sr, mu, wd):
    """The reference's packed fused wgrad in interpret mode, scattered into
    the dense (K, N) (or vmapped over a bank's groups) in f32: its raw f32
    m_new, or with sr the bf16-grid values.  w goes in as f32 (the same
    values), mom as bf16 or f32 (its dtype)."""
    f = lambda t, d: jnp.asarray(t.float().numpy(), d)
    jm = f(mom, JDT[mom.dtype])
    jseed = jnp.asarray(np.array([SEED], np.uint32).view(np.int32))
    ji, jc = jnp.asarray(idx.numpy()), jnp.asarray(cnt.numpy())
    jx, jg = f(x, JDT[x.dtype]), f(g, JDT[x.dtype])
    K, nkb = w.shape[-2], w.shape[-2] // BLOCK
    if x.dim() == 2:
        packed = jbsm._dw_fused_call(jx, jg, ji, jc, f(w, jnp.float32), jm, jseed, mu, wd, sr,
                                     16, BLOCK, BLOCK, True)
        out = jbsm._scatter_packed_dw(packed, ji, jc, nkb, BLOCK, BLOCK, jnp.float32)
    else:
        packed = jbsm._g_dw_fused_call(jx, jg, ji, jc, f(w, jnp.float32), jm, jseed, mu, wd,
                                       sr, 16, BLOCK, BLOCK, True)
        out = jax.vmap(lambda p, i, c: jbsm._scatter_packed_dw(
            p, i, c, nkb, BLOCK, BLOCK, jnp.float32))(packed, ji, jc)
    assert out.shape[-2] == K
    return torch.from_numpy(np.array(out))


# relative to the largest magnitude, as tests/test_torch_fused.py states: f32
# the same products summed in another order (plus one rounding where XLA's
# CPU code contracts mu * mom + acc into a fused multiply-add)
TOL = 1e-5


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", [
    # (G, M, K, N, real rows, n_split): 4 rows padded to 16 (half a slab);
    # 40 rows padded to 48 (1.5 slabs) split in two; a bank of 3 at 48 rows
    # (group 1 with no block) split in two
    (1, 16, 48, 80, 4, 1), (1, 48, 64, 96, 40, 2), (3, 48, 32, 96, 37, 2)])
def test_bs_dw_fused_split_plain_matches_the_reference_kernel(dtype, case):
    """The split plain version and the packed fused merge against the
    reference's Pallas fused wgrad (``_dw_fused_call``, or
    ``_g_dw_fused_call`` on a bank, with ``_scatter_packed_dw``) in
    interpret mode, on the same numpy inputs, mom in bf16: the raw new
    momentum (sr off, f32 output) within f32 tolerance; the reference's sr
    result bit for bit ``sr_to_bf16`` of its own raw output on the port's
    element ids (the padded extents' (g * K + row) * N + col), and the
    port's likewise; both +0.0 off the superset."""
    G, M, K, N, rows, n_split = case
    x, g, w, mom, idx, cnt, live = _problem(np.random.default_rng(67), G, M, K, N, dtype, BF,
                                            rows)
    x, g, w, mom, idx, cnt, live = _squeeze(G, x, g, w, mom, idx, cnt, live)
    gid = tmm._gid(K, N, "cpu", G=G if G > 1 else None)
    want = _reference(x, g, idx, cnt, w, mom, False, MU, WD)
    raw = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                 out_dtype=F32, **_kw(False))
    assert raw.shape == want.shape
    err = float((raw - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err
    merged = tbsm.bs_dw_fused_merge(_packed(x, g, idx, n_split, M, K, N), idx, cnt, w, mom,
                                    torch.zeros(want.shape), SEED, mu=MU, wd=WD, sr=False)
    assert torch.equal(merged, raw)
    assert torch.equal(_reference(x, g, idx, cnt, w, mom, True, MU, WD),
                       tmm.sr_to_bf16(want, SEED, gid))
    sr = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                **_kw(True))
    assert torch.equal(sr, tmm.sr_to_bf16(raw, SEED, gid).to(dtype))
    for t in (want, raw):
        assert not t[~live].any() and not bool(torch.signbit(t[~live]).any())


@pytest.mark.parametrize("G", [1, 3])
def test_bs_dw_fused_sr_is_the_reference_bit_for_bit(G):
    """On exact inputs (every f32 operation of m_new exact on both sides)
    the port's raw m_new equals the reference's, so its sr result, from the
    split plain version and from the packed fused merge, equals the
    reference's kernel's bit for bit: the same ids, the same rounding; mom
    in bf16 as the training path keeps it."""
    M, K, N = 48, 64, 96
    rng = np.random.default_rng(79)
    bm = _block_mask(rng, G, K // BLOCK, N // BLOCK)
    idx, cnt = (torch.from_numpy(a) for a in pack_group_mask(bm))
    x = torch.from_numpy(_exact(rng, (G, M, K), 1.0))
    g = torch.from_numpy(_exact(rng, (G, M, N), 1.0))
    w = torch.from_numpy(_exact(rng, (G, K, N), 0.25))
    mom = torch.from_numpy(_exact(rng, (G, K, N), 0.5)).to(BF)
    x, g, w, mom, idx, cnt = _squeeze(G, x, g, w, mom, idx, cnt)
    kw = dict(mu=0.5, wd=2.0**-10, bk=BLOCK, bn=BLOCK)
    want_raw = _reference(x, g, idx, cnt, w, mom, False, 0.5, 2.0**-10)
    want = _reference(x, g, idx, cnt, w, mom, True, 0.5, 2.0**-10)
    for n_split in (1, 2, 3):
        raw = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                     sr=False, out_dtype=F32, **kw)
        assert torch.equal(raw, want_raw), n_split
        got = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                     sr=True, out_dtype=F32, **kw)
        assert torch.equal(got, want), n_split
        merged = tbsm.bs_dw_fused_merge(_packed(x, g, idx, n_split, M, K, N), idx, cnt, w, mom,
                                        torch.zeros(want.shape), SEED, mu=0.5, wd=2.0**-10,
                                        sr=True)
        assert torch.equal(merged, want), n_split


@pytest.mark.parametrize("dtype", [F32, BF])
def test_bs_dw_fused_padded_slots_empty_and_dead_groups(dtype):
    """A bank of 4 (K8): padded slots (column 1 empty, column 0 one short of
    the width) and group 1 with no block give +0.0, never -0.0, sr off and
    on, split and unsplit; group 3, whose blocks are live but which got no
    rows (x and g zero), stores mu * mom + wd * w on its superset blocks
    (exactly the epilogue on a zero sum), and the merge of its zero
    partials the same; the reference's kernel in interpret mode agrees
    (within one f32 rounding: XLA's CPU code may contract mu * mom + wd * w
    into a fused multiply-add)."""
    G, M, K, N = 4, 32, 48, 64
    x, g, w, mom, idx, cnt, live = _problem(np.random.default_rng(83), G, M, K, N, dtype, BF)
    x[3] = 0.0
    g[3] = 0.0
    assert int(cnt[1].sum()) == 0 and int(cnt[3].sum()) > 0
    assert bool((cnt < idx.shape[-1]).any())
    dead = torch.where(live[3], MU * mom[3].float() + WD * w[3].float(), 0.0)
    for sr in (False, True):
        for n_split in (1, 2):
            got = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                         out_dtype=F32, **_kw(sr))
            off = got[~live]
            assert not off.any() and not bool(torch.signbit(off).any()), (sr, n_split)
            assert not got[1].any() and not bool(torch.signbit(got[1]).any())
            merged = tbsm.bs_dw_fused_merge(_packed(x, g, idx, n_split, M, K, N), idx, cnt, w,
                                            mom, torch.zeros(G, K, N), SEED, mu=MU, wd=WD,
                                            sr=sr)
            assert torch.equal(merged, got), (sr, n_split)
            if not sr:
                assert torch.equal(got[3], dead)
    ref = _reference(x, g, idx, cnt, w, mom, False, MU, WD)
    assert float((ref[3] - dead).abs().max()) <= TOL * max(1.0, float(dead.abs().max()))
    assert not ref[1].any() and not ref[~live].any()


@pytest.mark.parametrize("G", [1, 3])
def test_bs_dw_fused_inf_in_w_off_the_superset(G):
    """An inf in w and a NaN in mom in blocks outside the superset (the
    empty block column 1 and an inactive block) never reach m_new: the
    plain version, every split and the packed merge are finite and +0.0
    there, and agree with the reference's kernel, which never reads those
    blocks (interpret mode)."""
    M, K, N = 32, 64, 64
    x, g, w, mom, idx, cnt, live = _problem(np.random.default_rng(89), G, M, K, N, F32, F32)
    w[0, 5, BLOCK + 3] = float("inf")  # block column 1: empty
    mom[0, 5, BLOCK + 4] = float("nan")
    off = (~live[0]).nonzero()[-1]
    w[0, off[0], off[1]] = float("-inf")
    x, g, w, mom, idx, cnt, live = _squeeze(G, x, g, w, mom, idx, cnt, live)
    want = _reference(x, g, idx, cnt, w, mom, False, MU, WD)
    assert bool(torch.isfinite(want).all())
    for n_split in (1, 2):
        for sr in (False, True):
            got = tbsm.block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, SEED, n_split,
                                                         out_dtype=F32, **_kw(sr))
            assert bool(torch.isfinite(got).all()), (n_split, sr)
            assert not got[~live].any() and not bool(torch.signbit(got[~live]).any())
            merged = tbsm.bs_dw_fused_merge(_packed(x, g, idx, n_split, M, K, N), idx, cnt, w,
                                            mom, torch.zeros(want.shape), SEED, mu=MU, wd=WD,
                                            sr=sr)
            assert torch.equal(merged, got), (n_split, sr)
            if not sr:
                err = float((got - want).abs().max())
                assert err <= TOL * max(1.0, float(want.abs().max())), (n_split, err)


def test_the_fused_backward_takes_the_live_blocks_from_the_pack_entry(monkeypatch):
    """Given a momentum, the training path hands K7/K8's plan the pack
    entry's host int -- ``bnnz`` for a superset, ``nnz`` else -- and a bare
    tuple None (the wrapper then counts every slot), as K3/K6's; the count
    is never read from the device's ``bcnt``."""
    seen = []
    for name in ("block_sparse_dw_fused", "grouped_block_sparse_dw_fused"):
        real = getattr(tbsm, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["live"])
            return _real(*a, **kw)

        monkeypatch.setattr(tbsm, name, spy)
    rng = np.random.default_rng(97)
    m = torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.4, 16, 0), 16, 1))
    m[:16, :16] = True
    sup = m | torch.from_numpy(np.repeat(np.repeat(rng.random((4, 4)) < 0.3, 16, 0), 16, 1))
    e = pack_entry(m, (16, 16), bwd_mask=sup)
    fused = dict(seed=SEED, mu=MU, wd=WD, sr=True)
    x = torch.randn(5, 64)
    for pack in (e, {k: v for k, v in e.items() if k not in ("bidx", "bcnt", "bnnz")},
                 (e["idx"], e["cnt"])):
        w = torch.randn(64, 64, requires_grad=True)
        block_sparse_linear(x, w, pack=pack, block=(128, 16, 16), mom=torch.zeros(64, 64),
                            **fused).sum().backward()
    eg = pack_entry(m[None].repeat(3, 1, 1), (16, 16), bwd_mask=sup[None].repeat(3, 1, 1))
    wb = torch.randn(3, 64, 64, requires_grad=True)
    grouped_block_sparse_linear(torch.randn(3, 5, 64), wb, pack=eg, block=(128, 16, 16),
                                mom=torch.zeros(3, 64, 64), **fused).sum().backward()
    assert seen == [e["bnnz"], e["nnz"], None, eg["bnnz"]]
    assert e["bnnz"] == int(e["bcnt"].sum()) > e["nnz"] == int(e["cnt"].sum())
