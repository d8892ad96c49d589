"""Port MoE training vs the JAX package on qwen2-moe-a2.7b's smoke config.

Covers the slice bottom up: the grouped backward kernels' plain versions
(K5/K6 block-sparse on the stacked CSR and (superset) CSC, K17/K18 masked)
against the reference's grouped custom-VJP cotangents with a dead expert;
the grouped autograd Functions through ``ops`` against ``jax.grad`` of the
reference's wrappers; the MoE layer's gradients (router and aux included)
with the routing compared first; ``lm_loss`` gradients of every leaf in
both kernel modes, the banks held to the superset statement of the
reference's ``test_dispatch_total.py::test_grads_match_dense_reference``;
the remat rerun's routing; a RigL update over whole banks and the
optimizer-state reset; the pack refresh after an update (the reference's
``test_refresh_after_rigl_update_covers_grouped_banks``); the train CLI.

Routing is a discrete choice: a router logit one f32 rounding apart could
flip a top-k pick and move that token's gradient by O(1).  So every model
test compares the routing (top-k ids) exactly first, on inputs whose
k-th/(k+1)-th probability margin it states, and only then the numbers.
Inputs are made from seeds with numpy and handed to both packages; the port
runs its kernels' plain versions on the CPU, the reference its Pallas
kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core import rigl as jrigl  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.kernels import block_sparse_matmul as jbsm  # noqa: E402
from repro.kernels import masked_matmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import moe as jmoe_mod  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.optim import reset_new_connections as j_reset  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core import rigl as trigl  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.core.schedules import UpdateSchedule as TSchedule  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbsm  # noqa: E402
from repro_torch.kernels import masked_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe_mod  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.optim.optimizers import reset_new_connections as t_reset  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
BLOCK = 16
BLK = (128, BLOCK, BLOCK)
MODES = {
    "block_sparse": dict(sparsity=0.8, method="rigl", kernel="block_sparse",
                         block_shape=(BLOCK, BLOCK), kernel_block=BLK,
                         attn_kernel="flash_tight", delta_t=2),
    "masked": dict(sparsity=0.8, method="rigl", kernel="masked",
                   attn_kernel="flash_tight", delta_t=2),
}
# f32: the same products summed in another order, 1e-5 of the largest
# magnitude at a kernel, 1e-4 through the model (the slice-2 training
# tests' tolerance).  bf16 outputs: within ``matmul_error_bound`` (each side
# one f32 sum and one bf16 rounding).
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _as(a, dtype):
    """The same values in both frameworks: numpy f32 rounded to ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy(), JDT[dtype])


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _within_bound(got, want, abs_prod, n, what):
    """bf16: element by element within the port's ``matmul_error_bound``."""
    bound = tbsm.matmul_error_bound(got, abs_prod, n)
    err = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
    assert bool((err <= bound).all()), f"{what}: {float((err / bound).max())}x its bound"


def _bank(seed, G=5, nkb=4, nnb=3, dead=(2,), density=0.45):
    """A (G, nkb, nnb) block mask with a lopsided column (it sets the shared
    width), an all-empty column and dead experts."""
    rng = np.random.default_rng(seed)
    bm = rng.random((G, nkb, nnb)) < density
    bm[:, :, 1] = False
    bm[0, :, 0] = [True] * (nkb - 1) + [False]
    for g in dead:
        bm[g] = False
    return bm


def _dense(bm):
    return np.repeat(np.repeat(bm, BLOCK, -2), BLOCK, -1)


def _vjp(fn, x, w, g):
    _, pull = jax.vjp(fn, x, w)
    return pull(g)


# --------------------------------------------------------------------------
# K5/K6 and K17/K18: the plain versions against the reference's cotangents
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topkast", [False, True])
def test_grouped_block_sparse_bwd_plain_matches_reference(dtype, topkast):
    """K5 (dx on the stacked CSR) and K6 (dw on the stacked CSC, or the
    superset's under Top-KAST) against ``_gbs_bwd`` / ``_gtk_bwd``: expert
    2 dead (zero dx rows, zero dw), an all-empty column, the superset
    wider than the forward pack (its own shared width)."""
    bm = _bank(1)
    sup = bm | _bank(2, dead=(), density=0.3)
    sup[2] = bm[2]  # the dead expert stays dead in B too
    sup[0, :, 0] = True  # B's own shared width is wider
    G, nkb, nnb = bm.shape
    K, N, M = nkb * BLOCK, nnb * BLOCK, 32
    rng = np.random.default_rng(3)
    w = rng.standard_normal((G, K, N)).astype(np.float32) * _dense(sup) / np.sqrt(K)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    e = tpack.pack_entry(torch.from_numpy(_dense(bm)), (BLOCK, BLOCK), name="bank",
                         bwd_mask=torch.from_numpy(_dense(sup)))
    assert e["bidx"].shape[-1] > e["idx"].shape[-1]
    (xt, xj), (wt, wj), (gt, gj) = (_as(a, dtype) for a in (x, w, g))
    J = lambda k: jnp.asarray(e[k].numpy())
    kw = dict(bm=M, bn=BLOCK, bk=BLOCK, interpret=True)
    if topkast:
        fn = lambda a, b: jbsm.topkast_grouped_block_sparse_matmul(
            a, b, J("idx"), J("cnt"), J("bidx"), J("bcnt"), J("ridx"), J("rcnt"), **kw)
        didx, dcnt = e["bidx"], e["bcnt"]
    else:
        fn = lambda a, b: jbsm.grouped_block_sparse_matmul(
            a, b, J("idx"), J("cnt"), J("ridx"), J("rcnt"), **kw)
        didx, dcnt = e["idx"], e["cnt"]
    jdx, jdw = _vjp(fn, xj, wj, gj)
    dx = tbsm.grouped_block_sparse_dx_plain(gt, wt, e["ridx"], e["rcnt"], BLOCK, BLOCK)
    dw = tbsm.grouped_block_sparse_dw_plain(xt, gt, didx, dcnt, BLOCK, BLOCK)
    assert dx.dtype == dw.dtype == TDT[dtype]
    if dtype == "float32":
        _close(dx, jdx, 1e-5, "K5 dx")
        _close(dw, jdw, 1e-5, "K6 dw")
    else:
        ax = tbsm.grouped_block_sparse_dx_plain(gt.abs().float(), wt.abs().float(),
                                                e["ridx"], e["rcnt"], BLOCK, BLOCK)
        aw = tbsm.grouped_block_sparse_dw_plain(xt.abs().float(), gt.abs().float(),
                                                didx, dcnt, BLOCK, BLOCK)
        _within_bound(dx, jdx, ax, N, "K5 dx")
        _within_bound(dw, jdw, aw, M, "K6 dw")
    assert (dx[2] == 0).all() and (dw[2] == 0).all(), "the dead expert"
    blocks = torch.from_numpy(_dense(sup if topkast else bm))
    assert (dw[~blocks] == 0).all(), "dw outside the wgrad pack's blocks"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topkast", [False, True])
def test_grouped_masked_bwd_plain_matches_reference(dtype, topkast):
    """K17 (dx on the forward mask) and K18 (dw masked at the store by the
    forward mask, or the superset under Top-KAST) against ``_gmm_bwd`` /
    ``_gtkm_bwd``; expert 1 fully masked."""
    rng = np.random.default_rng(5)
    G, M, K, N = 4, 32, 64, 48
    mask = rng.random((G, K, N)) < 0.3
    mask[1] = False
    sup = mask | (rng.random((G, K, N)) < 0.1)
    sup[1] = False
    w = rng.standard_normal((G, K, N)).astype(np.float32) / np.sqrt(K)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    g = rng.standard_normal((G, M, N)).astype(np.float32)
    (xt, xj), (wt, wj), (gt, gj) = (_as(a, dtype) for a in (x, w, g))
    kw = dict(bm=M, bn=16, bk=16, interpret=True)
    if topkast:
        fn = lambda a, b: jmm.topkast_grouped_masked_matmul(
            a, b, jnp.asarray(mask), jnp.asarray(sup), **kw)
    else:
        fn = lambda a, b: jmm.grouped_masked_matmul(a, b, jnp.asarray(mask), **kw)
    dmask = torch.from_numpy(sup if topkast else mask)
    jdx, jdw = _vjp(fn, xj, wj, gj)
    mt = torch.from_numpy(mask)
    dx = tmm.grouped_masked_dx_plain(gt, wt, mt)
    dw = tmm.grouped_masked_dw_plain(xt, gt, dmask)
    if dtype == "float32":
        _close(dx, jdx, 1e-5, "K17 dx")
        _close(dw, jdw, 1e-5, "K18 dw")
    else:
        ax = tmm.grouped_masked_dx_plain(gt.abs().float(), wt.abs().float(), mt)
        aw = tmm.grouped_masked_dw_plain(xt.abs().float(), gt.abs().float(), dmask)
        _within_bound(dx, jdx, ax, N, "K17 dx")
        _within_bound(dw, jdw, aw, M, "K18 dw")
    assert (dx[1] == 0).all() and (dw[1] == 0).all()
    assert (dw[~dmask] == 0).all()


# --------------------------------------------------------------------------
# the grouped Functions through ops, against jax.grad of the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["block_sparse", "block_sparse_topkast",
                                  "block_sparse_bare", "masked", "masked_topkast"])
def test_grouped_functions_grad_match_jax(kind):
    """torch.autograd through ``ops.grouped_*_linear`` (7 rows padded to the
    16-row tile, N = 40 padded to the masked 16-wide tile) against jax.grad
    of the reference's wrappers: the pack entry's CSR, the superset entry,
    a bare ``(idx, cnt)`` tuple (stacked CSR derived at the worst-case
    width), the masked kernels and their Top-KAST carrier."""
    rng = np.random.default_rng(7)
    if kind.startswith("block_sparse"):
        bm = _bank(8, G=4, dead=(3,))
        sup = bm | _bank(9, G=4, dead=(3,), density=0.3)
        m, b = _dense(bm), _dense(sup)
    else:
        m = rng.random((4, 64, 40)) < 0.3
        m[3] = False
        b = m | (rng.random(m.shape) < 0.1)
        b[3] = False
    G, K, N = m.shape
    w = rng.standard_normal((G, K, N)).astype(np.float32) * (b if "block" in kind else 1)
    x = rng.standard_normal((G, 7, K)).astype(np.float32)
    ct = rng.standard_normal((G, 7, N)).astype(np.float32)
    if kind.startswith("block_sparse"):
        e = tpack.pack_entry(torch.from_numpy(m), (BLOCK, BLOCK),
                             bwd_mask=torch.from_numpy(b) if "topkast" in kind else None)
        je = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v for k, v in e.items()}
        if kind == "block_sparse_bare":
            e, je = (e["idx"], e["cnt"]), (je["idx"], je["cnt"])
        t_fn = lambda a, c: tops.grouped_block_sparse_linear(a, c, pack=e, block=BLK)
        j_fn = lambda a, c: jops.grouped_block_sparse_linear(a, c, pack=je, block=BLK,
                                                             interpret=True)
    elif kind == "masked":
        t_fn = lambda a, c: tops.grouped_masked_linear(a, c, torch.from_numpy(m), block=BLK)
        j_fn = lambda a, c: jops.grouped_masked_linear(a, c, jnp.asarray(m), block=BLK,
                                                       interpret=True)
    else:
        t_fn = lambda a, c: tops.topkast_grouped_masked_linear(
            a, c, torch.from_numpy(m), torch.from_numpy(b), block=BLK)
        j_fn = lambda a, c: jops.topkast_grouped_masked_linear(
            a, c, jnp.asarray(m), jnp.asarray(b), block=BLK, interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = t_fn(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(ct))
    jy, pull = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = pull(jnp.asarray(ct))
    _close(y, jy, 1e-5, f"{kind} y")
    _close(dx, jdx, 1e-5, f"{kind} dx")
    _close(dw, jdw, 1e-5, f"{kind} dw")
    assert (dw[3] == 0).all() and (dx[3] == 0).all(), "the dead expert"
    wgrad_support = torch.from_numpy(b if "topkast" in kind else m)
    assert (dw[~wgrad_support] == 0).all()


# --------------------------------------------------------------------------
# the MoE layer and the model: routing first, then gradients
# --------------------------------------------------------------------------

def _margin(probs, k):
    """Smallest gap between the k-th and (k+1)-th largest probability."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


def _configs(mode, **kw):
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32",
                               sparse=SparseConfig(**MODES[mode]), **kw)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32",
                               sparse=TSparse(**MODES[mode]), **kw)
    return jcfg, tcfg


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _bridge(st, opt=None):
    """The reference's train state (params, masks, supersets, pack or
    carrier) -> the port's, through the bridge."""
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    opt = opt or {k: (int(v) if k == "count" else _flat(v)) for k, v in st["opt"].items()}
    return bridge.train_state_from_flat(
        _flat(st["params"]), _flat(st["masks"]), bwd_masks=_flat(st["bwd_masks"]),
        pack={path_name(p): e for p, e in flat_k if e is not None}, opt=opt,
        step=int(st["step"]), device="cpu")


_STATES = {}


def _state(mode):
    """The reference's RigL train state of the smoke config (ERK 0.8, the
    Top-KAST superset, seed 0) and its bridge into the port, once per mode."""
    if mode not in _STATES:
        jcfg, tcfg = _configs(mode)
        st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg,
                                    OptConfig(kind="sgd"))
        _STATES[mode] = (jcfg, st), (tcfg, _bridge(st))
    return _STATES[mode]


def _record_routes(monkeypatch):
    """Record every top-k id set both packages pick: the port's ``route``
    and the reference's ``jax.lax.top_k`` (through a debug callback, so it
    records under jit and grad)."""
    seen = {"port": [], "jax": []}
    real_route, real_topk = tmoe_mod.route, jax.lax.top_k

    def route(p, xt, cfg):
        probs, gates, eidx = real_route(p, xt, cfg)
        seen["port"].append((probs.detach().numpy(), eidx.numpy()))
        return probs, gates, eidx

    def top_k(a, k):
        vals, idx = real_topk(a, k)
        jax.debug.callback(lambda i: seen["jax"].append(np.asarray(i)), idx)
        return vals, idx

    monkeypatch.setattr(tmoe_mod, "route", route)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return seen


def _check_routes(seen, k, n_calls):
    assert len(seen["port"]) == len(seen["jax"]) == n_calls
    for (probs, ti), ji in zip(seen["port"], seen["jax"]):
        assert _margin(probs, k) > 1e-5
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_moe_layer_grads_match_jax(monkeypatch, mode):
    """Layer 0's MoE on bridged weights, masks and the superset pack or
    carrier: 24 tokens (capacity binds, some assignments drop).  The top-k
    ids equal the reference's exactly; then the gradients of output + aux
    w.r.t. x and every leaf (router through the sorted top-k gates and
    aux's probs.mean, the banks, the shared MLP) within 1e-5, and the
    gradient of 0.01 * aux alone reaches the router."""
    (jcfg, st), (tcfg, tst) = _state(mode)
    lay = lambda tree: tree["layers"][0]["moe"]
    jp, jm, jk = lay(st["params"]), lay(st["masks"]), lay(st["pack"])
    tp, tmk, tk = lay(tst["params"]), lay(tst["masks"]), lay(tst["pack"])
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 8, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    seen = _record_routes(monkeypatch)

    def j_loss(p, xx, m, k):
        y, aux = jmoe_mod.moe(p, xx, jcfg, masks=m, pack=k)
        return jnp.sum(y * ct) + aux, 0.01 * aux

    (_, jaux), pull = jax.vjp(jax.jit(j_loss), jp, jnp.asarray(x), jm, jk)
    jg_p, jg_x = pull((1.0, 0.0))[:2]
    ja = pull((0.0, 1.0))[0]["router"]["w"]
    leaves = tree_map(lambda _, t: t.detach().clone().requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe_mod.moe(leaves, xt, tcfg, masks=tmk, pack=tk)
    loss = (y * torch.from_numpy(ct)).sum() + aux
    flat = tree_paths(leaves)
    grads = torch.autograd.grad(loss, [xt] + list(flat.values()))
    _check_routes(seen, jcfg.top_k, 1)
    assert tmoe_mod.capacity(24, tcfg) < 24 * tcfg.top_k / tcfg.n_experts * 2
    _close(grads[0], jg_x, 1e-5, "dx")
    want = _flat(jg_p)
    assert sorted(want) == sorted(flat)
    for (n, _), g in zip(flat.items(), grads[1:]):
        _close(g, want[n], 1e-5, n)
    ta = torch.autograd.grad(
        0.01 * tmoe_mod.moe(leaves, torch.from_numpy(x), tcfg, masks=tmk, pack=tk)[1],
        leaves["router"]["w"])[0]
    assert float(ta.abs().max()) > 0
    _close(ta, ja, 1e-5, "router grad of 0.01 aux")


@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_lm_loss_grads_match_jax(monkeypatch, mode):
    """``lm_loss`` (cross-entropy + 0.01 aux) of the 2-layer smoke model on
    the kernel path, both packages on the bridged RigL state: the routing
    of both layers exactly first, then the loss and every leaf's gradient
    within 1e-4.  The banks also hold the reference's superset statement:
    zero outside B, the plain dense path's gradient on A."""
    (jcfg, st), (tcfg, tst) = _state(mode)
    toks = np.random.default_rng(31).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    tg = np.roll(toks, -1, 1)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}
    tb = {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tg).long()}
    seen = _record_routes(monkeypatch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, m, k: j_lm_loss(p, jcfg, jb, masks=m, pack=k)))(
            st["params"], st["masks"], st["pack"])
    leaves = tree_map(lambda _, t: t.detach().clone().requires_grad_(True), tst["params"])
    loss = tm.lm_loss(leaves, tcfg, tb, masks=tst["masks"], pack=tst["pack"])
    flat = tree_paths(leaves)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    _check_routes(seen, jcfg.top_k, jcfg.n_layers)
    _close(loss, jl, 1e-5, "loss")
    want = _flat(jg)
    assert sorted(want) == sorted(grads)
    for n in want:
        _close(grads[n], want[n], 1e-4, n)
    # the plain dense path: dense matmuls on w * m, the plain softmax
    dense = dataclasses.replace(tcfg, sparse=dataclasses.replace(
        tcfg.sparse, kernel="dense", attn_kernel="dense"))
    dl = tm.lm_loss(leaves, dense, tb, masks=tst["masks"])
    jd = dict(zip(flat, torch.autograd.grad(dl, list(flat.values()))))
    masks, bwd = tree_paths(tst["masks"]), tree_paths(tst["bwd_masks"])
    banks = [n for n in masks if "/moe/w" in n]
    assert len(banks) == 3 * jcfg.n_layers
    for n in banks:
        a, b = masks[n], bwd[n]
        assert (grads[n][~b] == 0).all(), f"{n}: gradient outside the superset"
        assert bool((b & ~a).any()), f"{n}: the superset adds nothing"
        _close(grads[n] * a, jd[n] * a, 1e-4, f"{n} on A vs the dense path")


def test_remat_rerun_routes_identically(monkeypatch):
    """With ``cfg.remat`` the checkpoint region reruns each block's forward,
    routing included, in the backward: the rerun picks the same experts
    (top-k ids, hence keep and dest), and the gradients equal the run
    without remat bit for bit."""
    _, (tcfg, tst) = _state("block_sparse")
    toks = torch.from_numpy(np.random.default_rng(32).integers(0, tcfg.vocab_size, (2, 12)))
    tb = {"tokens": toks, "targets": toks.roll(-1, 1)}
    seen = []
    real = tmoe_mod.route

    def route(p, xt, cfg):
        out = real(p, xt, cfg)
        seen.append(out[2].clone())
        return out

    monkeypatch.setattr(tmoe_mod, "route", route)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_group=1)
        leaves = tree_map(lambda _, t: t.detach().clone().requires_grad_(True),
                          tst["params"])
        flat = tree_paths(leaves)
        loss = tm.lm_loss(leaves, cfg, tb, masks=tst["masks"], pack=tst["pack"])
        out[remat] = torch.autograd.grad(loss, list(flat.values()))
    L = tcfg.n_layers
    # once per layer without remat; with it the forward, then the backward's
    # reruns in reverse layer order
    assert len(seen) == 3 * L
    plain, fwd, rerun = seen[:L], seen[L:2 * L], seen[2 * L:][::-1]
    for i in range(L):
        assert torch.equal(fwd[i], plain[i])
        assert torch.equal(rerun[i], plain[i]), f"layer {i} rerun"
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# RigL over whole banks, the optimizer reset, the pack refresh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_rigl_update_on_banks_matches_jax(mode):
    """One drop/grow on deterministic scores (numpy-made gradients, no
    ties), both packages on the bridged state: the new masks, params and
    grown sets equal the reference's exactly, per bank over the WHOLE bank
    (one expert may gain or lose blocks), with counts kept; the Adam state
    reset for the grown connections matches."""
    (jcfg, st), (tcfg, tst) = _state(mode)
    block = (BLOCK, BLOCK) if mode == "block_sparse" else None
    rng = np.random.default_rng(40)
    grads = {n: rng.standard_normal(v.shape).astype(np.float32)
             for n, v in _flat(st["params"]).items()}
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(st["params"]),
        [jnp.asarray(grads[n]) for n in j_tree_paths(st["params"])])
    tgrads = bridge.params_from_flat(grads, "cpu")
    sched = dict(delta_t=2, t_end=8, alpha=0.3)
    jalgo = jrigl.SparseAlgo(method="rigl", schedule=jrigl.UpdateSchedule(**sched),
                             block_shape=block)
    talgo = trigl.SparseAlgo(method="rigl", schedule=TSchedule(**sched), block_shape=block)
    jp, jmk, jgrown = jrigl.rigl_update(st["params"], st["masks"], jgrads, 2, jalgo,
                                        jax.random.PRNGKey(0))
    tp, tmk, tgrown = trigl.rigl_update(tst["params"], tst["masks"], tgrads, 2, talgo)
    for a, b, what in ((tmk, jmk, "mask"), (tgrown, jgrown, "grown"), (tp, jp, "param")):
        want = _flat(b)
        for n, t in tree_paths(a).items():
            np.testing.assert_array_equal(t.numpy(), want[n], err_msg=f"{what} {n}")
    before, after = tree_paths(tst["masks"]), tree_paths(tmk)
    moved_experts = 0
    for n in [n for n in before if "/moe/w" in n]:
        assert int(after[n].sum()) == int(before[n].sum()), n
        per = lambda m: m.reshape(m.shape[0], -1).sum(-1)
        moved_experts += int((per(after[n]) != per(before[n])).sum())
    assert moved_experts > 0, "no expert gained or lost connections"
    opt = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in _flat(st["params"]).items()}
    jopt = {"m": jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(st["params"]),
        [jnp.asarray(opt[n]) for n in j_tree_paths(st["params"])])}
    jopt["v"] = jopt["m"]
    topt = {"m": bridge.params_from_flat(opt, "cpu"), "v": bridge.params_from_flat(opt, "cpu")}
    jr, tr = j_reset(jopt, jgrown), t_reset(topt, tgrown)
    for k in ("m", "v"):
        want = _flat(jr[k])
        for n, t in tree_paths(tr[k]).items():
            np.testing.assert_array_equal(t.numpy(), want[n], err_msg=f"opt {k} {n}")


def test_refresh_after_rigl_update_covers_grouped_banks():
    """Port of the reference's test of the same name on the port's own
    state: a train step with a fresh pack, a RigL step leaves the grouped
    banks' packs stale, ``refresh_pack`` makes them fresh (superset views
    included, widths never shrink, the pack valid), and the next train step
    is finite."""
    _, tcfg = _configs("block_sparse")
    opt = TOpt(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr = TLR(base_lr=3e-3, warmup_steps=2, total_steps=30)
    st, _ = tsteps.init_train_state(tcfg, opt, seed=1, device="cpu")
    train = tsteps.make_train_step(tcfg, opt, lr)
    rigl = tsteps.make_rigl_step(tcfg, tsteps.make_algo(tcfg, 30), lr)
    tb = lambda step: {k: torch.from_numpy(np.array(v)).long() for k, v in
                       batch_for(_configs("block_sparse")[0], step, 2, 16,
                                 learnable=True).items()}
    stale = lambda s: int(tpack.pack_mismatch(s["masks"], s["pack"], (BLOCK, BLOCK),
                                              bwd_masks=s["bwd_masks"]))
    st, m = train(st, tb(0))
    assert stale(st) == 0
    widths = {n: (e["idx"].shape[-1], e["ridx"].shape[-1], e["bidx"].shape[-1])
              for n, e in tpack.pack_entries(st["pack"])}
    assert any(e["idx"].dim() == 3 for _, e in tpack.pack_entries(st["pack"]))
    st, _ = rigl(st, tb(1))
    assert stale(st) > 0, "rigl moved no blocks"
    st = tsteps.refresh_pack(st, tcfg)
    assert stale(st) == 0
    assert tpack.validate_pack(st["pack"]) == len(widths)
    for n, e in tpack.pack_entries(st["pack"]):
        got = (e["idx"].shape[-1], e["ridx"].shape[-1], e["bidx"].shape[-1])
        assert all(a >= b for a, b in zip(got, widths[n])), n
    st, m = train(st, tb(2))
    assert stale(st) == 0 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("kernel", ["block_sparse", "masked"])
def test_train_cli_runs_moe(tmp_path, kernel):
    """The train CLI on ``--arch qwen2-moe-a2.7b --smoke --device cpu``:
    updates at every delta_t, finite losses, the pack fresh, sparsity kept."""
    import json

    from repro_torch.launch.train import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6", "--delta-t",
          "2", "--kernel", kernel, "--block", str(BLOCK), "--workdir", str(tmp_path)])
    res = json.loads((tmp_path / "result.json").read_text())
    rec = res["metrics"][-1]
    assert rec["step"] == 6 and np.isfinite(rec["loss"]) and rec["nonfinite_steps"] == 0
    assert rec.get("pack_stale", 0) == 0 and abs(res["sparsity"] - 0.8) < 0.02
