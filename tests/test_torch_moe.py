"""Port MoE serving vs the JAX package on qwen2-moe-a2.7b's smoke config.

Covers the slice bottom up: the config copy; ERK over 3-D expert banks;
block masks and stacked per-expert packs (a dead expert, an all-zero bank);
the grouped kernels' plain versions (K4 block-sparse, K16 masked) against
the reference's grouped Pallas kernels in interpret mode, and their
gradients; ``moe`` with its routing decisions first, then outputs and aux;
``lm_prefill``/``lm_decode`` logits; the serving engine's streams; the
dead-slot isolation of expert capacity; the prefix cache refused; paged vs
contiguous; the fused epilogue on banks routed by ``grouped_linear``
(training itself: tests/test_torch_moe_train.py and
tests/test_torch_moe_fused.py).

Routing is a discrete choice: a router logit that differs in its last f32
bit between XLA and torch could flip a top-k pick and move that token's
output by O(1).  The moe tests therefore compare the routing first, on
inputs whose k-th/(k+1)-th probability margin is stated and not tiny, and
only then the outputs.  Inputs are made from seeds with numpy and handed to
both packages; the port runs its kernels' plain versions on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core import pack as jpack  # noqa: E402
from repro.core.distributions import LayerSpec as JSpec  # noqa: E402
from repro.core.distributions import get_distribution as j_dist  # noqa: E402
from repro.core.masks import block_mask_of as j_block_mask_of  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.models import moe as jmoe_mod  # noqa: E402
from repro.models.layers import assert_total_dispatch as j_atd  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro.training.steps import sparsity_map as j_sparsity_map  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.distributions import LayerSpec, get_distribution  # noqa: E402
from repro_torch.core.distributions import sparsity_map  # noqa: E402
from repro_torch.core.masks import block_mask_of, random_block_mask, tree_paths  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import configure_kernel, init_serving_state  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe_mod  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402
from repro_torch.training.steps import init_train_state as t_init_train_state  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
BLOCK = 16
# serve states: a static topology (no Top-KAST superset, which only the
# training path reads)
MODES = {
    "block_sparse": dict(sparsity=0.8, method="static", kernel="block_sparse",
                         block_shape=(BLOCK, BLOCK), kernel_block=(128, BLOCK, BLOCK),
                         attn_kernel="flash_tight"),
    "masked": dict(sparsity=0.8, method="static", kernel="masked",
                   attn_kernel="flash_tight"),
    "dense": dict(sparsity=0.8, method="static", kernel="dense", attn_kernel="dense"),
}
# f32: the same products summed in another order (1e-6 relative at the
# kernel, 1e-5 through the router's softmax and the combine, 1e-4 on the
# logits as in the slice-1 model tests).  bf16: both sides accumulate in f32
# and round once to bf16, so an output lands at most one bf16 ulp (2**-7 of
# its magnitude) apart; the bf16 logits tolerance is the slice-1 model
# tests' 5e-3.
KERNEL_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _close(got, want, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _configs(mode, dtype="float32", **kw):
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                               sparse=SparseConfig(**MODES[mode]), **kw)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=dtype,
                               sparse=TSparse(**MODES[mode]), **kw)
    return jcfg, tcfg


def _bridge(st, mode):
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    tmasks = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu")
    tk = None
    if mode == "block_sparse":
        flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"],
                                                         is_leaf=jpack.is_pack_entry)
        tk = bridge.pack_from_flat(
            {path_name(p): e for p, e in flat_k if e is not None}, tp, "cpu")
    return tp, tmasks, tk


_STATES = {}


def _state(mode, dtype="float32"):
    """The reference's serve state of the smoke config (ERK 0.8, seed 0) and
    its bridge into the port, built once per mode (the f32 masters and the
    topology do not depend on the compute dtype)."""
    if mode not in _STATES:
        st, _, _ = init_train_state(jax.random.PRNGKey(0), _configs(mode)[0],
                                    OptConfig())
        _STATES[mode] = (st["params"], st["masks"], st.get("pack")), _bridge(st, mode)
    jcfg, tcfg = _configs(mode, dtype)
    (jp, jm, jk), (tp, tmasks, tk) = _STATES[mode]
    return (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tk)


# --------------------------------------------------------------------------
# config, distributions, masks, packs
# --------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for smoke in (False, True):
        assert (dataclasses.asdict(t_get_config(ARCH, smoke=smoke))
                == dataclasses.asdict(get_config(ARCH, smoke=smoke)))


def _reference_shapes(cfg):
    box = {}

    def init(key):
        params, _, flags = j_init_lm(key, cfg)
        box["flags"] = flags
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return j_tree_paths(shapes), j_tree_paths(box["flags"])


@pytest.mark.parametrize("smoke", [True, False])
def test_erk_over_expert_banks_matches_reference(smoke):
    """ERK counts the expert dim as a kernel dim.  At the full widths and
    sparsity 0.8 the attention and shared-expert matrices come out dense
    and every expert bank at density 0.121."""
    sp = dict(sparsity=0.8, distribution="erk")
    jcfg = dataclasses.replace(get_config(ARCH, smoke=smoke), sparse=SparseConfig(**sp))
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=smoke), sparse=TSparse(**sp))
    shapes, flags = _reference_shapes(jcfg)
    want = j_sparsity_map(jcfg, shapes, flags)
    got = sparsity_map(tcfg, shapes, flags)
    if smoke:
        assert sparsity_map(tcfg, *tm.init_lm(tcfg, device="cpu")) == got
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-12), name
    specs = [JSpec(n, tuple(shapes[n].shape)) for n in want]
    assert get_distribution("erk", [LayerSpec(s.name, s.shape) for s in specs], 0.8) \
        == pytest.approx(j_dist("erk", specs, 0.8))
    if not smoke:
        for name, s in got.items():
            if "/moe/w" in name:  # the banks wi/wg/wo
                assert 1 - s == pytest.approx(0.121, abs=5e-4), name
            else:
                assert s == 0.0, name


def test_block_masks_of_banks():
    """A 3-D bank draws block-aligned masks over its trailing two dims with
    one exact count over the bank; the block view keeps the group dim and
    equals the reference's."""
    gen = torch.Generator().manual_seed(0)
    m = random_block_mask(gen, (6, 64, 32), 0.75, (16, 16))
    bm = block_mask_of(m, (16, 16))
    assert bm.shape == (6, 4, 2) and int(bm.sum()) == 12
    np.testing.assert_array_equal(
        torch.repeat_interleave(torch.repeat_interleave(bm, 16, 1), 16, 2).numpy(), m.numpy())
    np.testing.assert_array_equal(
        bm.numpy(), np.asarray(j_block_mask_of(m.numpy(), (16, 16))))


def _bank_blocks(seed=0, G=5, nkb=4, nnb=6, dead=(2,)):
    rng = np.random.default_rng(seed)
    bm = rng.random((G, nkb, nnb)) < 0.4
    bm[:, :, 1] = False  # an all-empty column in every group
    bm[0, :, 0] = True  # one lopsided column sets the shared width
    for g in dead:
        bm[g] = False  # a dead expert
    return bm


def test_group_packs_match_reference():
    bm = _bank_blocks()
    for fn, jfn, worst in ((tpack.pack_group_mask, jbsm.pack_group_mask, 4),
                           (tpack.pack_group_mask_rows, jbsm.pack_group_mask_rows, 6)):
        for mc in (None, worst):
            got, want = fn(bm, mc), jfn(bm, mc)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
    idx, cnt = tpack.pack_group_mask(bm)
    assert idx.shape == (5, 6, 4) and (cnt[2] == 0).all()
    with pytest.raises(ValueError, match="max_count"):
        tpack.pack_group_mask(bm, 2)


def test_grouped_pack_entry_matches_reference():
    """The stacked entry (CSC, CSR, nnz, nkb and a superset view) equals the
    reference's; a dead expert is legal; an all-zero bank raises in both;
    validate_pack accepts the entry and catches a corrupted count; the pack
    statistics see the groups."""
    bm = _bank_blocks()
    m = np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)
    bw = m | np.repeat(np.repeat(_bank_blocks(1, dead=()), BLOCK, 1), BLOCK, 2)
    got = tpack.pack_entry(torch.from_numpy(m), (BLOCK, BLOCK), name="bank",
                           bwd_mask=torch.from_numpy(bw))
    want = jpack.pack_entry(m, (BLOCK, BLOCK), name="bank", bwd_mask=bw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert tpack.validate_pack({"moe": {"wi": {"w": got}}}) == 1
    s_got = tpack.pack_stats({"moe": {"wi": {"w": got}}})["layers"]["moe/wi/w"]
    s_want = jpack.pack_stats({"moe": {"wi": {"w": want}}})["layers"]["moe/wi/w"]
    assert s_got == pytest.approx(s_want)
    assert s_got["groups"] == 5
    bad = dict(got, cnt=got["cnt"].clone())
    bad["cnt"][0, 0] += 1
    with pytest.raises(tpack.PackIntegrityError):
        tpack.validate_pack({"moe": {"wi": {"w": bad}}})
    zero = np.zeros_like(m)
    with pytest.raises(ValueError, match="ZERO active blocks"):
        tpack.pack_entry(torch.from_numpy(zero), (BLOCK, BLOCK), name="bank")
    with pytest.raises(ValueError, match="ZERO active blocks"):
        jpack.pack_entry(zero, (BLOCK, BLOCK), name="bank")


def test_bridge_carries_moe_state():
    """The reference's MoE params (router, banks, shared MLP), masks and
    grouped 3-D pack leaves come across unchanged and round-trip."""
    (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tk) = _state("block_sparse")
    lp = tp["layers"][0]["moe"]
    assert lp["router"]["w"].shape == (64, 6) and tmasks["layers"][0]["moe"]["router"]["w"] is None
    assert lp["wo"]["w"].shape == (6, 32, 64) and "shared" in lp
    e = tk["layers"][0]["moe"]["wi"]["w"]
    assert e["idx"].dim() == 3 and e["idx"].shape[:2] == (6, 2)
    flat_k, _ = jax.tree_util.tree_flatten_with_path(jk, is_leaf=jpack.is_pack_entry)
    want = {path_name(p): v for p, v in flat_k if v is not None}
    got = bridge.pack_flat_of(tk)
    assert got.keys() == want.keys() and any("/moe/shared/" in n for n in got)
    for n, ent in want.items():
        for k, v in ent.items():
            np.testing.assert_array_equal(np.asarray(got[n][k]), np.asarray(v), err_msg=n)
    for n, v in j_tree_paths(jp).items():
        np.testing.assert_array_equal(bridge.flat_of(tp)[n], np.asarray(v), err_msg=n)


# --------------------------------------------------------------------------
# the grouped kernels' plain versions vs the reference's Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_block_sparse_matches_jax_kernel(dtype):
    """K4 through ``ops.grouped_block_sparse_linear``: 5 experts (one dead,
    one all-empty column each), 5 rows padded to the 16-row tile."""
    bm = _bank_blocks(3)
    G, nkb, nnb = bm.shape
    K, N = nkb * BLOCK, nnb * BLOCK
    rng = np.random.default_rng(4)
    dense = np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2)
    w = rng.standard_normal((G, K, N)).astype(np.float32) * dense / np.sqrt(K)
    x = rng.standard_normal((G, 5, K)).astype(np.float32)
    entry = tpack.pack_entry(torch.from_numpy(dense), (BLOCK, BLOCK))
    xt, xj = _as(x, dtype)
    wt, wj = _as(w, dtype)
    got = tops.grouped_block_sparse_linear(xt, wt, pack=entry,
                                           block=(128, BLOCK, BLOCK))
    want = jops.grouped_block_sparse_linear(
        xj, wj, block=(128, BLOCK, BLOCK), interpret=True,
        pack=(jnp.asarray(entry["idx"].numpy()), jnp.asarray(entry["cnt"].numpy())))
    assert got.dtype == TDT[dtype]
    _close(got, want, KERNEL_TOL[dtype], "grouped block-sparse")
    assert (got[2] == 0).all(), "the dead expert's output is not zero"
    assert (got[:, :, BLOCK:2 * BLOCK] == 0).all(), "an empty column is not zero"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_masked_matches_jax_kernel(dtype):
    """K16 through ``ops.grouped_masked_linear``: an elementwise mask with
    one expert fully masked, 5 rows and N = 80 padded to the 32-wide tile."""
    rng = np.random.default_rng(5)
    G, K, N = 4, 64, 80
    mask = rng.random((G, K, N)) < 0.3
    mask[1] = False
    w = rng.standard_normal((G, K, N)).astype(np.float32) / np.sqrt(K)
    x = rng.standard_normal((G, 5, K)).astype(np.float32)
    xt, xj = _as(x, dtype)
    wt, wj = _as(w, dtype)
    got = tops.grouped_masked_linear(xt, wt, torch.from_numpy(mask), block=(128, 32, 32))
    want = jops.grouped_masked_linear(xj, wj, jnp.asarray(mask), block=(128, 32, 32),
                                      interpret=True)
    _close(got, want, KERNEL_TOL[dtype], "grouped masked")
    assert (got[1] == 0).all()


def _fused_entry(mom, entry=None):
    """A fused-epilogue pack entry as the train step merges it (mu 0.5, wd
    2**-4, sr off), over an optional PackState entry."""
    return dict(entry or {}, mom=mom, seed=7, mu=0.5, wd=2.0**-4, sr=False)


def test_grouped_kernels_backward_raises():
    """The grouped backward kernels (K5/K6, K17/K18, ported with MoE
    training) give the dense product's gradients on w * m, zero outside the
    mask; the grouped fused epilogue (K8/K20) gives the new momentum mu *
    mom + dw + wd * w on the mask as the weight's cotangent."""
    bm = _bank_blocks(6, G=2, dead=())
    dense = torch.from_numpy(np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2))
    w0 = torch.randn(dense.shape, dtype=torch.float64).float()
    x0 = torch.randn(2, 4, dense.shape[1])
    entry = tpack.pack_entry(dense, (BLOCK, BLOCK))
    xd, wd = x0.double().requires_grad_(True), w0.double().requires_grad_(True)
    torch.bmm(xd, wd * dense).sum().backward()
    for run in (lambda x, w: tops.grouped_block_sparse_linear(
                    x, w, pack=entry, block=(128, BLOCK, BLOCK)),
                lambda x, w: tops.grouped_masked_linear(
                    x, w, dense, block=(128, BLOCK, BLOCK))):
        x, w = x0.clone().requires_grad_(True), (w0 * dense).requires_grad_(True)
        run(x, w).sum().backward()
        _close(x.grad, xd.grad, 1e-5, "dx")
        _close(w.grad, wd.grad, 1e-5, "dw")
        assert (w.grad[~dense] == 0).all()
    mom = torch.randn(w0.shape) * dense
    for kernel, e in (("block_sparse", entry), ("masked", None)):
        w = (w0 * dense).requires_grad_(True)
        tl.grouped_linear(w, x0, mask=dense, kernel=kernel, block=(128, BLOCK, BLOCK),
                          pack=_fused_entry(mom, e)).sum().backward()
        want = (0.5 * mom.double() + wd.grad + 2.0**-4 * w.detach().double()) * dense
        _close(w.grad, want, 1e-5, f"{kernel} fused cotangent")


def test_grouped_linear_dispatch():
    """``grouped_linear`` in each mode equals the dense product on w * m and
    refuses block_sparse without a pack; a fused-epilogue entry gives the
    same product and the new momentum as w's cotangent."""
    bm = _bank_blocks(7, G=3, dead=(1,))
    m = torch.from_numpy(np.repeat(np.repeat(bm, BLOCK, 1), BLOCK, 2))
    w = torch.randn(m.shape, dtype=torch.float64).float()
    x = torch.randn(3, 7, m.shape[1])
    want = torch.bmm(x.double(), (w * m).double()).float()
    entry = tpack.pack_entry(m, (BLOCK, BLOCK))
    blk = (128, BLOCK, BLOCK)
    for kernel, pack in (("block_sparse", entry), ("masked", None), ("dense", None)):
        got = tl.grouped_linear(w, x, mask=m, kernel=kernel, block=blk, pack=pack)
        _close(got, want, 1e-5, kernel)
    # without an entry the call packs the mask's blocks itself: the same
    # product as with the prebuilt entry, bit for bit
    got = tl.grouped_linear(w, x, mask=m, kernel="block_sparse", block=blk)
    assert torch.equal(got, tl.grouped_linear(w, x, mask=m, kernel="block_sparse",
                                              block=blk, pack=entry))
    # a fused-epilogue entry: the same product, the new momentum as w's
    # cotangent (K8 on the pack's blocks, K20 on the mask)
    mom = torch.randn(m.shape) * m
    dw = torch.bmm(x.double().transpose(1, 2), torch.ones(3, 7, m.shape[2]).double())
    for kernel, pack in (("block_sparse", _fused_entry(mom, entry)),
                         ("masked", _fused_entry(mom))):
        wg = w.clone().requires_grad_(True)
        got = tl.grouped_linear(wg, x, mask=m, kernel=kernel, block=blk, pack=pack)
        _close(got.detach(), want, 1e-5, f"{kernel} fused")
        got.sum().backward()
        _close(wg.grad, (0.5 * mom.double() + dw + 2.0**-4 * w.double()) * m, 1e-5,
               f"{kernel} fused cotangent")


def test_assert_total_dispatch_per_submodule():
    """A mask leaf no dispatched matmul consumes is loud, as in the
    reference; dense kernels and a fully consumed subtree pass."""
    m = torch.ones(2, 2, dtype=torch.bool)
    masks = {"router": {"w": None}, "wi": {"w": m}, "extra": {"w": m}}
    with pytest.raises(RuntimeError, match="extra"):
        tl.assert_total_dispatch(masks, ("wi",), kernel="masked", where="moe")
    tl.assert_total_dispatch(masks, ("wi", "extra"), kernel="block_sparse")
    tl.assert_total_dispatch(masks, ("wi",), kernel="dense")
    jm = {"router": {"w": None}, "wi": {"w": m.numpy()}, "extra": {"w": m.numpy()}}
    with pytest.raises(RuntimeError, match="extra"):
        j_atd(jm, ("wi",), kernel="masked", where="moe")


# --------------------------------------------------------------------------
# moe: routing decisions first, then outputs and aux
# --------------------------------------------------------------------------

def _margin(probs, k):
    """Smallest gap between the k-th and (k+1)-th largest probability."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


def _record_banks(monkeypatch, module):
    """Record the token buffer each grouped bank receives: the (E, C, d)
    scatter of the routed tokens, which pins top-k, capacity, ranks, keep
    and dest together (a row holds the token its dest names)."""
    seen = []
    real = module.grouped_linear

    def spy(w, x, *a, **kw):
        seen.append(np.array(x.float().numpy() if torch.is_tensor(x)
                             else np.asarray(x, np.float32)))
        return real(w, x, *a, **kw)

    monkeypatch.setattr(module, "grouped_linear", spy)
    return seen


@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
@pytest.mark.parametrize("B,S,act", [(3, 8, None), (4, 1, (1, 0, 1, 1))])
def test_moe_matches_jax(monkeypatch, mode, B, S, act):
    """Layer 0's MoE on bridged weights, masks and packs: a prefill-shaped
    batch of 24 tokens (capacity C = 10 binds: some assignments drop) and a
    decode-shaped one with a dead slot.  The routing (top-k ids, then the
    scattered bank inputs) equals the reference's exactly; outputs and aux
    within the f32 tolerance."""
    (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tk) = _state(mode)
    rng = np.random.default_rng(10 * B + S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    active = None if act is None else np.asarray(act, bool)
    lp = lambda tree: None if tree is None else tree["layers"][0]["moe"]
    jseen = _record_banks(monkeypatch, jmoe_mod)
    tseen = _record_banks(monkeypatch, tmoe_mod)
    jy, jaux = jmoe_mod.moe(lp(jp), jnp.asarray(x), jcfg, masks=lp(jm), pack=lp(jk),
                            active=None if active is None else jnp.asarray(active))
    ty, taux = tmoe_mod.moe(lp(tp), torch.from_numpy(x), tcfg, masks=lp(tmasks),
                            pack=lp(tk),
                            active=None if active is None else torch.from_numpy(active))
    # routing: the margin precondition, the top-k ids, then the buffers
    xt = torch.from_numpy(x).reshape(-1, jcfg.d_model)
    tprobs, _, teidx = tmoe_mod.route(lp(tp), xt, tcfg)
    jlogits = jnp.asarray(x).reshape(-1, jcfg.d_model) @ lp(jp)["router"]["w"]
    _, jeidx = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1), jcfg.top_k)
    assert _margin(tprobs.numpy(), jcfg.top_k) > 1e-4
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(jeidx))
    assert len(tseen) == len(jseen) == 3
    C = tmoe_mod.capacity(B * S, tcfg)
    assert tseen[0].shape == (jcfg.n_experts, C, jcfg.d_model)
    np.testing.assert_array_equal(tseen[0], jseen[0])
    if act is None:  # capacity binds at 24 tokens: some assignment dropped
        assert (tseen[0].any(-1).sum() < B * S * jcfg.top_k)
    _close(ty, jy, 1e-5, "moe output")
    assert abs(float(taux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))


def test_moe_ties_take_the_lower_expert():
    """Equal router probabilities pick the lower expert id first, as
    jax.lax.top_k does."""
    cfg = t_get_config(ARCH, smoke=True)
    p = {"router": {"w": torch.zeros(cfg.d_model, cfg.n_experts)}}
    _, gates, eidx = tmoe_mod.route(p, torch.randn(3, cfg.d_model), cfg)
    assert eidx.tolist() == [[0, 1]] * 3
    assert torch.allclose(gates, torch.full_like(gates, 0.5))


# --------------------------------------------------------------------------
# the model: prefill and per-slot decode logits
# --------------------------------------------------------------------------

def _close_logits(got, want, cfg, dtype, what):
    V = cfg.vocab_size
    want = np.asarray(want, np.float32)
    _close(got[..., :V], want[..., :V], LOGIT_TOL[dtype], what)
    assert (got[..., V:] == -1e30).all()


@pytest.mark.parametrize("mode,dtype", [("block_sparse", "float32"),
                                        ("block_sparse", "bfloat16"),
                                        ("masked", "float32")])
def test_prefill_and_decode_match_jax(mode, dtype):
    """Two slots admitted (9-token prompts) into shared caches, then 3
    per-slot decode steps, slot 0 inactive for the last two (its position
    falls behind): the prefill and decode logits within the slice-1
    tolerances."""
    (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tk) = _state(mode, dtype)
    tp = tm.serving_weights(tp, tcfg)
    max_len = 24
    jc = j_init_caches(jcfg, 2, max_len)
    tc = tm.init_caches(tcfg, 2, max_len, "cpu")
    j_into = jax.jit(lambda p, m, k, c, t, slot: j_lm_prefill_into(
        p, jcfg, c, {"tokens": t}, slot, max_len, masks=m, pack=k))
    j_decode = jax.jit(lambda p, m, k, c, t, pos, act: j_lm_decode(
        p, jcfg, c, t, pos, masks=m, pack=k, active=act))
    tok = []
    for slot, L in enumerate((9, 9)):
        prompt = np.random.default_rng(20 + slot).integers(
            0, jcfg.vocab_size, (1, L)).astype(np.int32)
        jl, jc = j_into(jp, jm, jk, jc, jnp.asarray(prompt), slot)
        tl_, tc = tm.lm_prefill_into(tp, tcfg, tc, {"tokens": torch.from_numpy(prompt).long()},
                                     slot, max_len, masks=tmasks, pack=tk)
        _close_logits(tl_, jl, tcfg, dtype, f"prefill slot {slot}")
        tok.append(int(np.argmax(np.asarray(jl)[0, -1])))
    pos = np.array([9, 9])
    cur = np.array(tok)
    for step in range(3):
        active = np.array([step < 1, True])
        jl, jc = j_decode(jp, jm, jk, jc, jnp.asarray(cur)[:, None], jnp.asarray(pos),
                          jnp.asarray(active))
        tl_, tc = tm.lm_decode(tp, tcfg, tc, torch.from_numpy(cur)[:, None].long(),
                               torch.from_numpy(pos), masks=tmasks, pack=tk,
                               active=torch.from_numpy(active))
        _close_logits(tl_[active], np.asarray(jl)[active], tcfg, dtype, f"decode {step}")
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)
        pos = pos + active
        cur = np.where(active, nxt, cur)


def test_lm_loss_adds_the_aux_loss():
    """lm_loss is the chunked cross-entropy plus 0.01 times the summed
    load-balancing loss, as the reference's (forward value); dense kernels
    on the masked weights."""
    (_, jp, jm, _), (_, tp, tmasks, _) = _state("block_sparse")
    jcfg, tcfg = _configs("dense")
    jk = tk = None
    toks = np.random.default_rng(30).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    tg = np.roll(toks, -1, 1)
    want = jax.jit(lambda p, m, b: j_lm_loss(p, jcfg, b, masks=m))(
        jp, jm, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    with torch.no_grad():
        got = tm.lm_loss(tp, tcfg, {"tokens": torch.from_numpy(toks).long(),
                                    "targets": torch.from_numpy(tg).long()},
                         masks=tmasks, pack=tk)
        _, _, aux = tm.lm_forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                                  masks=tmasks, pack=tk)
    assert float(aux) > 0
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# --------------------------------------------------------------------------
# the serving engine
# --------------------------------------------------------------------------

REQ = dict(prompt_lens=(5, 9), gen_lens=(6, 4, 5))


def _drain(engine):
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


def test_engine_streams_match_jax():
    """The port engine against the reference engine on the bridged
    block-sparse state: the same requests, exact-length prefills (no
    bucket: a pad token would take expert capacity), the same slots, equal
    greedy streams."""
    (jcfg, jp, jm, jk), (tcfg, tp, tmasks, tk) = _state("block_sparse")
    jreqs, treqs = j_requests(jcfg, 3, **REQ), t_requests(tcfg, 3, **REQ)
    engines = {}
    for name, Engine, cfg, params, masks, pack, reqs in (
            ("jax", JEngine, jcfg, jp, jm, jk, jreqs),
            ("port", TEngine, tcfg, tp, tmasks, tk, treqs)):
        engines[name] = Engine(cfg, params, capacity=2, max_len=24, masks=masks,
                               pack=pack)
        for r in reqs:
            assert engines[name].submit(r)
        _drain(engines[name])
    assert engines["port"]._padded_len(9) == 9
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.status is Status.DONE for r in treqs)
    assert engines["port"].slot_history == engines["jax"].slot_history


def _port_state(mode="block_sparse", **kw):
    cfg = configure_kernel(t_get_config(ARCH, smoke=True), kernel=mode,
                           block=BLOCK if mode == "block_sparse" else None,
                           attn_kernel="flash_tight")
    cfg = dataclasses.replace(cfg, dtype="float32", **kw)
    return (cfg, *init_serving_state(cfg, seed=0, device="cpu"))


def test_moe_dead_slots_cannot_contend_expert_capacity():
    """Port of the reference's test of the same name: at the DEFAULT
    capacity factor (capacity 8, C = 4 binds), active requests in slots 4-7
    and dead slots 0-3 holding varied stale tokens and positions: the
    active rows' logits are bit-identical whatever the dead slots hold."""
    cfg, params, masks, pack = _port_state()
    params = tm.serving_weights(params, cfg)
    cap, max_len = 8, 16
    assert tmoe_mod.capacity(cap, cfg) < cap, "C no longer binds"
    caches = tm.init_caches(cfg, cap, max_len, "cpu")
    pos = np.zeros(cap, np.int64)
    active = np.zeros(cap, bool)
    cur = np.zeros(cap, np.int64)
    for i in range(4):
        s = 4 + i
        t = np.random.default_rng(40 + i).integers(0, cfg.vocab_size, (1, 4))
        logits, caches = tm.lm_prefill_into(params, cfg, caches,
                                            {"tokens": torch.from_numpy(t)}, s, max_len,
                                            masks=masks, pack=pack)
        cur[s] = int(logits[0, -1].argmax())
        pos[s], active[s] = 4, True

    def active_logits(dead_tok, dead_pos):
        tok, p = cur.copy(), pos.copy()
        tok[:4], p[:4] = dead_tok, dead_pos
        logits, _ = tm.lm_decode(params, cfg, caches, torch.from_numpy(tok)[:, None],
                                 torch.from_numpy(p), masks=masks, pack=pack,
                                 active=torch.from_numpy(active))
        return logits[4:, -1]

    ref = active_logits(0, 0)
    for dead_tok, dead_pos in ((1, 0), (97, 3), (cfg.vocab_size - 1, 9)):
        assert torch.equal(active_logits(dead_tok, dead_pos), ref)


def test_prefix_cache_refused_for_moe():
    cfg, params, masks, pack = _port_state()
    with pytest.raises(ValueError, match="without experts"):
        TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                paged=True, prefix_cache=2)


@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_paged_moe_engine_matches_contiguous(mode):
    """The paged engine (allowed for MoE, as in the reference) streams the
    same greedy tokens as the contiguous one."""
    cfg, params, masks, pack = _port_state(mode)
    streams = []
    for paged in (False, True):
        engine = TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                         paged=paged, page_size=8)
        reqs = t_requests(cfg, 4, prompt_lens=(6, 11), gen_lens=(5, 7))
        for r in reqs:
            engine.submit(r)
        _drain(engine)
        if paged:
            engine.check_pool_accounting()
        assert all(r.status is Status.DONE for r in reqs)
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]


def test_serve_cli_runs_moe():
    """The serve CLI accepts the MoE config on the CPU (the bank tiling
    check reads a 3-D bank's trailing dims) and serves every request."""
    from repro_torch.launch.serve import main
    stats = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kernel",
                  "block_sparse", "--block", str(BLOCK), "--requests", "3"])
    assert stats["requests"] == 3 and stats["failed"] == 0


def test_moe_training_refused():
    """MoE training is ported, the fused SGD epilogue on the expert banks
    (K8/K20) included (tests/test_torch_moe_train.py,
    tests/test_torch_moe_fused.py), and so is bf16 Adam state: the state
    starts with bf16 moments and one step leaves f32 ones for every leaf,
    the banks' included, as the reference's ``apply_opt`` returns them."""
    from repro_torch.data.synthetic import batch_for as t_batch_for
    from repro_torch.optim.lr import LRSchedule as TLR
    from repro_torch.optim.optimizers import OptConfig as TOpt
    from repro_torch.training.steps import make_train_step

    cfg = dataclasses.replace(t_get_config(ARCH, smoke=True), sparse=TSparse(
        sparsity=0.8, method="rigl", kernel="masked", fused_epilogue=True))
    st, _ = t_init_train_state(cfg, TOpt(kind="sgd", state_dtype="bfloat16"), device="cpu")
    assert st["opt"]["momentum"]["layers"][0]["moe"]["wi"]["w"].dim() == 3
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                              fused_epilogue=False))
    adam = TOpt(kind="adam", state_dtype="bfloat16")
    st, _ = t_init_train_state(cfg, adam, device="cpu")
    bank = lambda s, k: s["opt"][k]["layers"][0]["moe"]["wi"]["w"]
    assert bank(st, "m").dtype == bank(st, "v").dtype == torch.bfloat16
    st, met = make_train_step(cfg, adam, TLR())(
        st, t_batch_for(cfg, 0, 2, 8, learnable=True, device="cpu"))
    assert bool(torch.isfinite(met["loss"]))
    for k in ("m", "v"):
        assert bank(st, k).dtype == torch.float32 and bank(st, k).dim() == 3
        assert {t.dtype for t in tree_paths(st["opt"][k]).values()} == {torch.float32}
