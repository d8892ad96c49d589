"""``remat_policy='dots'`` of the port against the JAX package's
``jax.checkpoint_policies.checkpoint_dots``, on danube's and qwen2-moe's
SMOKE configs in the dense mode (dense products, dense attention) and both
kernel modes (block-sparse K1-K6 and masked K13-K18 with the Top-KAST
superset, flash attention K9-K11: their plain versions on the CPU), f32.
The weights are the reference's ``init_lm`` draws carried across by the
bridge; masks and supersets are drawn with numpy from a seed.

Two statements.  The loss and every leaf's gradient under 'dots' equal the
reference's ``jax.grad`` under its policy (1e-5 and 1e-4 of the largest
magnitude, the training tests' tolerances): the reference's dense
gradient G at the masked weights, restricted as each mode's statement
says (dense mode: G on the mask A; kernel modes: G on the superset B, the
wgrad's channel).  And one region's saved tensors are the reference's
``saved_residuals`` in the same mode (its Pallas kernels traced in
interpret mode): the values it keeps beyond the region's inputs and
constants, compared by element count and dtype, kernel outputs never
among them.  Where the two differ, the test names the difference: torch's
einsum saves its ``bmm``'s 3-D output where the reference keeps a 5-D
``dot_general`` output of the same elements; the reference keeps
``silu(wg_out)`` where the port keeps ``wg_out`` (one shape); and torch's
selective checkpoint saves by policy alone, so it also keeps the products
whose outputs no backward formula reads (the MLP's last projection, the
MoE combine), which JAX's partial evaluation drops as dead.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import apply_masks, tree_map, tree_paths  # noqa: E402
from repro_torch.core.pack import build_bwd_carrier, build_pack_state  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe_mod  # noqa: E402

BLOCK = 16
MODES = {
    "dense": dict(sparsity=0.8, kernel="dense", attn_kernel="dense"),
    "block_sparse": dict(sparsity=0.8, kernel="block_sparse", block_shape=(BLOCK, BLOCK),
                         kernel_block=(128, BLOCK, BLOCK), attn_kernel="flash_tight"),
    "masked": dict(sparsity=0.8, kernel="masked", attn_kernel="flash_tight"),
}
ARCHS = ("h2o-danube-1.8b", "qwen2-moe-a2.7b")
B, S = 2, 12
CASES = [(a, m) for a in ARCHS for m in MODES]
REMAT = dict(dtype="float32", remat=True, remat_group=1, remat_policy="dots")


def _cfgs(arch, mode):
    return (dataclasses.replace(get_config(arch, smoke=True),
                                sparse=SparseConfig(**MODES[mode]), **REMAT),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                sparse=TSparse(**MODES[mode]), **REMAT))


def _draw_masks(flat, flags, blocks: bool, seed: int = 7):
    """{name: (A, B)} for every sparsifiable leaf: A keeps ~20% (whole
    16 x 16 blocks of the trailing dims under ``blocks``), the superset B
    adds ~10% more."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, w in flat.items():
        if not flags[n]:
            continue
        *g, K, N = w.shape
        shape = (*g, K // BLOCK, N // BLOCK) if blocks else w.shape
        u = rng.random(shape)
        a, b = u < 0.2, u < 0.3
        if blocks:
            a, b = (np.repeat(np.repeat(m, BLOCK, -2), BLOCK, -1) for m in (a, b))
        out[n] = (a, b)
    return out


_REFS = {}


def _ref(arch):
    """The reference's SMOKE weights (``init_lm``, seed 0) and sparse flags,
    once per arch."""
    if arch not in _REFS:
        jcfg, _ = _cfgs(arch, "dense")
        box = {}

        def init(key):
            params, _, box["flags"] = j_model.init_lm(key, jcfg)
            return params

        params = jax.jit(init)(jax.random.PRNGKey(0))
        flags = {path_name(p): f for p, f in
                 jax.tree_util.tree_flatten_with_path(box["flags"])[0]}
        _REFS[arch] = {n: np.asarray(v) for n, v in j_tree_paths(params).items()}, flags
    return _REFS[arch]


def _state(arch, mode):
    """-> (masked weights {name: array}, {name: (A, B)}, the port's params,
    masks and pack (the superset view: ``bidx`` or the carrier))."""
    flat, flags = _ref(arch)
    ab = _draw_masks(flat, flags, mode == "block_sparse")
    w = {n: v * ab[n][0] if n in ab else v for n, v in flat.items()}
    params = bridge.params_from_flat(w, "cpu")
    masks = bridge.masks_from_flat({n: a for n, (a, _) in ab.items()}, params, "cpu")
    bwd = bridge.masks_from_flat({n: b for n, (_, b) in ab.items()}, params, "cpu")
    pack = None
    if mode == "block_sparse":
        pack = build_pack_state(masks, (BLOCK, BLOCK), device="cpu", bwd_masks=bwd)
    elif mode == "masked":
        pack = build_bwd_carrier(bwd)
    return w, ab, params, masks, pack


def _j_tree(like, flat):
    """The reference's params tree with the leaves of ``flat``."""
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[path_name(p)]), like)


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _margin(probs, k):
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


_GRADS = {}


def _batches(cfg):
    toks = np.random.default_rng(31).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tg = np.roll(toks, -1, 1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)},
            {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tg).long()})


def _ref_grads(arch, mode):
    """(loss, G): the reference's loss and dense gradient at the masked
    weights under 'dots' (dense products, dense attention).  Once per arch
    and mask kind (the masked mode's weights are the dense mode's)."""
    key = (arch, mode == "block_sparse")
    if key not in _GRADS:
        jcfg, _ = _cfgs(arch, "dense")
        w = _state(arch, mode)[0]
        like = jax.eval_shape(lambda k: j_model.init_lm(k, jcfg)[0], jax.random.PRNGKey(0))
        jb = _batches(jcfg)[0]
        loss, g = jax.jit(jax.value_and_grad(lambda p: j_lm_loss(p, jcfg, jb)))(
            _j_tree(like, w))
        _GRADS[key] = float(loss), {n: np.asarray(v) for n, v in j_tree_paths(g).items()}
    return _GRADS[key]


@pytest.mark.parametrize("arch,mode", CASES)
def test_dots_grads_match_reference(monkeypatch, arch, mode):
    """The loss and every leaf's gradient of ``lm_loss`` under 'dots'
    against ``jax.value_and_grad`` of the reference's under
    ``checkpoint_dots``.  An MoE model's routing first: every pick's
    k-th/(k+1)-th probability margin is above 1e-5 (no f32 rounding flips
    it) and the backward's reruns pick what the forward picked."""
    _, tcfg = _cfgs(arch, mode)
    _, ab, params, masks, pack = _state(arch, mode)
    jl, G = _ref_grads(arch, mode)
    tb = _batches(tcfg)[1]
    routes = []
    if tcfg.n_experts:
        real = tmoe_mod.route

        def route(p, xt, cfg):
            out = real(p, xt, cfg)
            routes.append((out[0].detach().numpy(), out[2].clone().numpy()))
            return out

        monkeypatch.setattr(tmoe_mod, "route", route)
    leaves = tree_map(lambda _, t: t.detach().clone().requires_grad_(True), params)
    if mode == "dense":
        loss = tm.lm_loss(apply_masks(leaves, masks), tcfg, tb)
    else:
        loss = tm.lm_loss(leaves, tcfg, tb, masks=masks, pack=pack)
    flat = tree_paths(leaves)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    if tcfg.n_experts:
        # the forward's picks, then the backward's reruns of the same ones
        assert len(routes) == 2 * tcfg.n_layers
        for probs, _ in routes:
            assert _margin(probs, tcfg.top_k) > 1e-5
        fwd, rerun = routes[:tcfg.n_layers], routes[tcfg.n_layers:][::-1]
        for (_, a), (_, b) in zip(fwd, rerun):
            np.testing.assert_array_equal(a, b)
    _close(loss, jl, 1e-5, "loss")
    assert sorted(G) == sorted(grads)
    for n, g in G.items():
        if n in ab:  # the mode's channel: A on the dense path, B for the wgrad kernels
            g = g * ab[n][0 if mode == "dense" else 1]
        _close(grads[n], g, 1e-4, n)


def _layer0(tree):
    return None if tree is None else tree["layers"][0]


def _port_saved(monkeypatch, arch, tcfg, mode, x):
    """(numel, dtype) of every tensor layer 0's 'dots' region saves beyond
    its input, recorded from the policy's decisions on the first forward."""
    _, _, params, masks, pack = _state(arch, mode)
    saved = []
    real = tm.dots_policy

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append((ctx.op_output.numel(), str(ctx.op_output.dtype).split(".")[-1]))
        return out

    monkeypatch.setattr(tm, "dots_policy", policy)
    dense = mode == "dense"
    p0 = apply_masks(_layer0(params), _layer0(masks)) if dense else _layer0(params)
    kw = {} if dense else dict(masks=_layer0(masks), pack=_layer0(pack))
    torch.utils.checkpoint.checkpoint(
        lambda x_: tm._block(p0, x_, tcfg, 0, positions=torch.arange(S), **kw)[0],
        torch.from_numpy(x).requires_grad_(True), use_reentrant=False,
        context_fn=tm.dots_contexts)
    return sorted(saved)


def _ref_saved(arch, jcfg, mode, x):
    """(numel, dtype) of the reference's saved residuals of layer 0's
    region under ``checkpoint_dots`` (its kernels on the traced block masks
    in the kernel modes), its inputs and constants left out."""
    w, ab, *_ = _state(arch, mode)
    like = jax.eval_shape(lambda k: j_model.init_lm(k, jcfg)[0], jax.random.PRNGKey(0))
    p0 = _layer0(_j_tree(like, w))
    m0 = None
    if mode != "dense":
        m0 = _layer0(jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(ab[path_name(p)][0]) if path_name(p) in ab else None,
            like))
    sched = j_model.A.attn_schedules(jcfg, S)

    def region(p, x_):
        return j_model._block(p, x_, jcfg, 0, positions=jnp.arange(S), masks=m0,
                              attn_sched=sched)[0]

    res = saved_residuals(jax.checkpoint(region, policy=jax.checkpoint_policies.checkpoint_dots),
                          p0, jnp.asarray(x))
    return sorted((int(np.prod(a.shape)), str(a.dtype)) for a, why in res
                  if "from the argument" not in why and "from a constant" not in why)


@pytest.mark.parametrize("arch,mode", CASES)
def test_dots_saves_the_reference_residuals(monkeypatch, arch, mode):
    """One region's saved tensors against the reference's, by element
    count and dtype.  The port saves the reference's residuals and, where
    named, more: the MLP's (a dense MoE's shared MLP's) last projection and
    the MoE's combine product, whose outputs no backward formula reads.
    Under either kernel mode nothing a kernel computes is saved: danube
    saves nothing, qwen2-moe its router's logits (and the combine)."""
    jcfg, tcfg = _cfgs(arch, mode)
    x = np.random.default_rng(5).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    port = _port_saved(monkeypatch, arch, tcfg, mode, x)
    ref = _ref_saved(arch, jcfg, mode, x)
    tokens_x_d = (B * S * jcfg.d_model, "float32")
    # products whose outputs feed only the region's output
    dead = {("h2o-danube-1.8b", "dense"): [tokens_x_d],
            ("qwen2-moe-a2.7b", "dense"): [tokens_x_d, tokens_x_d],
            ("qwen2-moe-a2.7b", "block_sparse"): [tokens_x_d],
            ("qwen2-moe-a2.7b", "masked"): [tokens_x_d]}.get((arch, mode), [])
    assert port == sorted(ref + dead), (port, ref)
    if mode != "dense" and not jcfg.n_experts:
        assert port == []
