"""Port MoE training with the fused SGD epilogue vs the JAX package on
qwen2-moe-a2.7b's smoke config: the fused train step under kernel
'block_sparse' (K7 on the projections, K8 on the expert banks) and 'masked'
(K19, K20), f32 and bf16 momentum (stochastic rounding), against the
reference's fused step and the port's own unfused step; and the epilogue's
per-leaf seed over an MoE mask tree in the reference's flatten order.

Routing is a discrete choice: a router logit one f32 rounding apart could
flip a top-k pick and move that token's gradient by O(1).  So the steps'
top-k ids are compared exactly first, on batches whose k-th/(k+1)-th
probability margin is stated, and only then the numbers (as
tests/test_torch_moe_train.py does).  The port runs its kernels' plain
versions on the CPU, the reference its Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import init_train_state, make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import flat_index, tree_paths  # noqa: E402
from repro_torch.core.pack import pack_entries  # noqa: E402
from repro_torch.models import moe as tmoe_mod  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
BLOCK = 16
MODES = {
    "block_sparse": dict(sparsity=0.8, method="rigl", kernel="block_sparse",
                         block_shape=(BLOCK, BLOCK), kernel_block=(128, BLOCK, BLOCK),
                         attn_kernel="flash_tight", delta_t=2, fused_epilogue=True),
    "masked": dict(sparsity=0.8, method="rigl", kernel="masked",
                   attn_kernel="flash_tight", delta_t=2, fused_epilogue=True),
}
B, S, STEPS = 2, 16, 2
LR = dict(base_lr=3e-3, warmup_steps=0, total_steps=10)
# f32 on both sides (the same arithmetic summed in another order), relative
# to each leaf's largest magnitude: the slice-2 training tests' 1e-4.  bf16
# momentum: f32 values that close may round (stochastically on the fused
# leaves, to nearest on the others) to neighbouring bf16 values, one ulp
# (at most 2**-7 of the leaf's largest entry) in each of the 2 steps:
# 2**-6; the params then move apart by at most lr times that per step.
TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs(mode, fused=True):
    sp = dict(MODES[mode], fused_epilogue=fused)
    kw = dict(dtype="float32", microbatches=1)
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), sparse=SparseConfig(**sp), **kw)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), sparse=TSparse(**sp), **kw)
    return jcfg, tcfg


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _bridge(st):
    """The reference's train state (bf16 momentum banks included) -> the
    port's, through the bridge."""
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    return bridge.train_state_from_flat(
        _flat(st["params"]), _flat(st["masks"]), bwd_masks=_flat(st["bwd_masks"]),
        pack={path_name(p): e for p, e in flat_k if e is not None},
        opt={"momentum": _flat(st["opt"]["momentum"])}, step=int(st["step"]),
        device="cpu")


def _margin(probs, k):
    """Smallest gap between the k-th and (k+1)-th largest probability."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


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


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.float32(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    bound = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_moe_fused_steps_match_jax_and_unfused(monkeypatch, mode, state_dtype):
    """Two fused SGD steps (momentum 0.9, wd 1e-4) of the 2-layer smoke
    model on the bridged RigL state: every top-k pick equal to the
    reference's (margin > 1e-5), then the loss, params and momentum within
    ``TOL`` of the reference's fused step, the momentum stored in the
    state's dtype; and against the port's unfused step the reference's own
    bounds (tests/test_fused_epilogue.py: params 2e-6, momentum 1e-5, loss
    1e-5 with f32 state; bf16: 2e-2 of the largest momentum)."""
    jcfg, tcfg = _configs(mode)
    jopt, topt = (C(kind="sgd", momentum=0.9, weight_decay=1e-4, grad_clip=0.0,
                    state_dtype=state_dtype) for C in (OptConfig, TOpt))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    tst = _bridge(st)
    ust = _bridge(st)
    mom = tree_paths(tst["opt"]["momentum"])
    assert all(m.dtype == TDT[state_dtype] for m in mom.values())
    assert mom["layers/0/moe/wi/w"].dim() == 3  # the bridge carries the banks
    seen = _record_routes(monkeypatch)
    j_step = jax.jit(make_train_step(jcfg, jopt, LRSchedule(**LR)))
    t_step = tsteps.make_train_step(tcfg, topt, TLR(**LR))
    u_step = tsteps.make_train_step(_configs(mode, fused=False)[1], topt, TLR(**LR))
    for step in range(STEPS):
        jb = batch_for(jcfg, step, B, S, learnable=True)
        tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
        n, nj = len(seen["port"]), len(seen["jax"])
        st, jm = j_step(st, jb)
        tst, tm = t_step(tst, tb)
        jax.effects_barrier()
        assert len(seen["port"]) - n == len(seen["jax"]) - nj == jcfg.n_layers
        for (probs, ti), ji in zip(seen["port"][n:], seen["jax"][nj:]):
            assert _margin(probs, jcfg.top_k) > 1e-5
            np.testing.assert_array_equal(ti, ji)
        _close(tm["loss"], jm["loss"], TOL["float32"], f"step {step} loss")
        ust, um = u_step(ust, tb)
    want_p, want_m = _flat(st["params"]), _flat(st["opt"]["momentum"])
    for n, v in tree_paths(tst["opt"]["momentum"]).items():
        _close(v, want_m[n], TOL[state_dtype], f"momentum {n}")
    for n, v in tree_paths(tst["params"]).items():
        err = float(np.abs(v.numpy() - want_p[n]).max())
        bound = TOL["float32"] * float(np.abs(want_p[n]).max())
        if state_dtype == "bfloat16":
            bound += LR["base_lr"] * STEPS * TOL["bfloat16"] * float(np.abs(want_m[n]).max())
        assert err <= bound, f"params {n}: max |port - jax| = {err} > {bound}"
    diff = lambda a, b: max(float((x.float() - y.float()).abs().max()) for x, y in zip(
        tree_paths(a).values(), tree_paths(b).values()))
    mref = max(float(x.float().abs().max()) for x in tree_paths(ust["opt"]["momentum"]).values())
    if state_dtype == "float32":
        assert diff(ust["params"], tst["params"]) < 2e-6
        assert diff(ust["opt"]["momentum"], tst["opt"]["momentum"]) < 1e-5
        assert abs(float(um["loss"]) - float(tm["loss"])) < 1e-5
    else:
        assert diff(ust["opt"]["momentum"], tst["opt"]["momentum"]) < 2e-2 * max(mref, 1e-3)


@pytest.mark.parametrize("mode", ["block_sparse", "masked"])
def test_fused_seed_over_an_moe_mask_tree_follows_the_reference(mode):
    """The fused epilogue's per-leaf seed index over qwen2-moe's mask tree
    (attention, the shared MLP, the router's None leaf, the 3-D banks) is
    the leaf's position in ``jax.tree_util.tree_flatten(masks, is_leaf=is
    None)``; every mask leaf's fused entry carries ``fused_seed(step, i)``
    and its own momentum bank, and the banks' entries keep their grouped
    pack (or carrier) view."""
    jcfg, tcfg = _configs(mode)
    opt = OptConfig(kind="sgd", momentum=0.9, state_dtype="bfloat16")
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    flat, _ = jax.tree_util.tree_flatten_with_path(st["masks"], is_leaf=lambda x: x is None)
    want = {path_name(p): i for i, (p, _) in enumerate(flat)}
    tst = _bridge(st)
    assert flat_index(tst["masks"]) == want
    assert any(m is None for _, m in flat)
    tst["step"] = 2148  # past the int32 wrap of step * 1000003
    topt = TOpt(kind="sgd", momentum=0.9, state_dtype="bfloat16")
    pack = tsteps._fused_pack(tst, topt)
    mom = tree_paths(tst["opt"]["momentum"])
    entries = dict(pack_entries(pack))
    masks = tree_paths(tst["masks"])
    assert sorted(entries) == sorted(masks)
    view = "bidx" if mode == "block_sparse" else "bwd_mask"
    banks = [n for n in masks if "/moe/w" in n]
    assert banks and all(masks[n].dim() == 3 for n in banks)
    for n, e in entries.items():
        with np.errstate(over="ignore"):
            ref = np.array([2148], np.int32) * np.int32(1000003) + np.int32(want[n])
        assert e["seed"] == int(ref.view(np.uint32)[0]), n
        assert e["mom"] is mom[n] and view in e and e["sr"] and e["mu"] == 0.9
        if n in banks and mode == "block_sparse":
            assert e["bidx"].dim() == 3
