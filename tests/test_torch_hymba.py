"""Port hymba (hymba-1.5b) vs the JAX package on the smoke config, block 16.

Covers the slice bottom up: the config copy, the init layout and ERK map
(``ssm/in_proj`` and ``ssm/out_proj`` sparse, the scan's weights dense
bare leaves), the packs (entries for the two projections only); the
causal conv and its step; ``ssm`` over several chunks with its final
state and gradients; ``ssm_decode`` stepped token by token against the
full forward; ``lm_forward``, ``lm_loss`` and its gradients (the tied
table's included) under dense, masked and block_sparse on the
reference's own weights carried by ``bridge``.  Serving (prefill, decode,
the engine, the CLIs) is ``test_torch_hymba_serve.py``, on this file's
states.

The port's kernel modes run their kernels' plain versions on the CPU.  The
reference runs kernel='dense' with the same masks (``w * m`` in every
matmul: the same function, and a masked gradient like the kernels'), so no
interpret-mode kernel runs.  Tolerances, relative to the largest magnitude
compared: 1e-4 for f32 results (the scan's doubling order against
``jax.lax.associative_scan``'s odd/even recursion, and the products summed
in another order); 5e-3 for the bf16 config's logits (bf16 attention).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core import pack as jpack  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm_forward as j_lm_forward  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro.training.steps import sparsity_map as j_sparsity_map  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.distributions import sparsity_map  # noqa: E402
from repro_torch.core.masks import apply_masks, init_masks, tree_map, tree_paths  # noqa: E402
from repro_torch.launch.serve import configure_kernel  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

ARCH = "hymba-1.5b"
BLOCK = 16
TOL = 1e-4
MODES = ("dense", "masked", "block_sparse")


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _jx(tree):
    """A port tree (tensors, None leaves) as the reference's (jnp arrays)."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().float().numpy()) if t.dtype.is_floating_point
        else jnp.asarray(t.detach().numpy()), tree)


def _cfgs(dtype="float32"):
    """(reference config, port config) of the smoke model at ``dtype``:
    ERK 0.8, the reference dense (``w * m``), the port block-sparse."""
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                               sparse=SparseConfig(sparsity=0.8, kernel="dense"))
    tcfg = configure_kernel(dataclasses.replace(t_get_config(ARCH, smoke=True),
                                                dtype=dtype),
                            kernel="block_sparse", block=BLOCK)
    return jcfg, tcfg


_STATES = {}


def _state(mode, dtype="float32"):
    """The reference's init weights (seed 0), carried into the port by
    ``bridge``; the port's 16x16-block ERK masks (one topology for every
    mode) applied to them; the pack under block_sparse."""
    key = dtype
    if key not in _STATES and dtype != "float32":  # the same f32 masters
        _, _, params, masks, pack = _state("block_sparse")
        _STATES[key] = (*_cfgs(dtype), params, masks, pack)
    if key not in _STATES:
        jcfg, cfg = _cfgs(dtype)
        box = {}

        def init(k):
            p, _, box["flags"] = j_init_lm(k, jcfg)
            return p

        jparams = jax.jit(init)(jax.random.PRNGKey(0))
        params = bridge.params_from_flat(
            {n: np.asarray(a) for n, a in j_tree_paths(jparams).items()}, "cpu")
        flags = j_tree_paths(box["flags"])
        smap = sparsity_map(cfg, params, tree_map(lambda n, _: bool(flags[n]), params))
        masks = init_masks(torch.Generator().manual_seed(1), params, smap,
                           block_shape=(BLOCK, BLOCK))
        params = apply_masks(params, masks)
        pack = tpack.build_pack_state(masks, (BLOCK, BLOCK), device="cpu")
        _STATES[key] = (jcfg, cfg, params, masks, pack)
    jcfg, cfg, params, masks, pack = _STATES[key]
    if mode != "block_sparse":
        cfg, pack = configure_kernel(cfg, kernel=mode), None
    return jcfg, cfg, params, masks, pack


# --------------------------------------------------------------------------
# config, init, ERK, packs
# --------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for smoke in (False, True):
        assert (dataclasses.asdict(t_get_config(ARCH, smoke=smoke))
                == dataclasses.asdict(get_config(ARCH, smoke=smoke)))
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.ssm_d_inner, full.ssm_state) == (32, 1600, 25, 5, 64, 3200, 16)
    assert [full.layer_kind(i) for i in (0, 1, 15, 30, 31)] == [
        "global", "local", "global", "local", "global"]
    assert tm.padded_vocab(full) == 32256 and full.tie_embeddings


def _reference_shapes(cfg):
    box = {}

    def init(key):
        params, _, flags = j_init_lm(key, cfg)
        box["flags"] = flags
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return j_tree_paths(shapes), j_tree_paths(box["flags"])


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """Paths, shapes and sparse flags of the reference's tree (no ``head``:
    tied; the SSM's dense bare leaves), and the same ERK map.  The full
    config is checked on shapes alone."""
    sp = SparseConfig(sparsity=0.8, distribution="erk")
    jcfg = dataclasses.replace(get_config(ARCH, smoke=smoke), sparse=sp)
    tcfg = t_get_config(ARCH, smoke=smoke)
    shapes, flags = _reference_shapes(jcfg)
    assert "head/w" not in shapes
    if smoke:
        tp, tf = tm.init_lm(tcfg, device="cpu")
        got = tree_paths(tp)
        assert sorted(got) == sorted(shapes)
        for n, s in shapes.items():
            assert tuple(got[n].shape) == tuple(s.shape), n
        assert tree_paths(tf) == {n: bool(v) for n, v in flags.items()}
    want = j_sparsity_map(jcfg, shapes, flags)
    got = sparsity_map(tcfg, shapes, flags)
    assert got.keys() == want.keys()
    assert "layers/0/ssm/in_proj/w" in got and "layers/0/ssm/w_dt/w" not in got
    for n in want:
        assert got[n] == pytest.approx(want[n], abs=1e-12), n


def test_packs_cover_ssm_and_match_reference():
    """Entries for ``in_proj`` and ``out_proj`` (none for the scan's dense
    weights), equal to the reference's ``build_pack_state`` on the same
    masks."""
    _, _, _, masks, pack = _state("block_sparse")
    got = bridge.pack_flat_of(pack)
    assert sorted(got) == sorted(tree_paths(masks))
    assert {n.split("/", 3)[3] for n in got if "/ssm/" in n} == {"in_proj/w", "out_proj/w"}
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jpack.build_pack_state(tree_map(lambda _, m: None if m is None else m.numpy(), masks),
                               (BLOCK, BLOCK)),
        is_leaf=jpack.is_pack_entry)
    want = {path_name(p): e for p, e in jflat if e is not None}
    assert sorted(want) == sorted(got)
    for n, e in want.items():
        for k in ("idx", "cnt", "ridx", "rcnt"):
            assert np.array_equal(got[n][k], np.asarray(e[k])), (n, k)
        assert got[n]["nnz"] == int(e["nnz"])


# --------------------------------------------------------------------------
# the conv and the SSM
# --------------------------------------------------------------------------

def _ssm_params():
    _, cfg, params, _, _ = _state("dense")
    return cfg, params["layers"][1]["ssm"]


def test_conv1d_causal_and_step_match_reference():
    """The full conv, and the step form from a bf16 state (the window
    promotes to f32, as jnp's concatenate) against the reference's."""
    _, p = _ssm_params()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, p["conv"]["w"].shape[1])).astype(np.float32)
    st = jnp.asarray(rng.standard_normal((2, 3, x.shape[2])), jnp.bfloat16)
    jp = _jx(p["conv"])
    _close(L.conv1d_causal(p["conv"], torch.from_numpy(x)),
           jax.jit(jL.conv1d_causal)(jp, x), "conv1d_causal")
    tst = torch.from_numpy(np.array(st.astype(jnp.float32))).to(torch.bfloat16)
    new, y = L.conv1d_causal_step(p["conv"], tst, torch.from_numpy(x[:, 0]))
    jnew, jy = jax.jit(jL.conv1d_causal_step)(jp, st, jnp.asarray(x[:, 0]))
    assert new.dtype == torch.float32 and jnew.dtype == jnp.float32
    assert np.array_equal(new.numpy(), np.asarray(jnew))
    _close(y, jy, "conv1d_causal_step")


def test_ssm_chunks_state_and_grads_match_reference():
    """S = 150 over q_chunk 64 (chunks of 64, 64, 22): the output, the final
    h and the gradients of <out, cotangent> + sum(h) w.r.t. x and every
    leaf (``a_log``, ``dt_bias``, ``d_skip``, the conv's included)."""
    cfg, p = _ssm_params()
    x = np.random.default_rng(1).standard_normal((2, 150, cfg.d_model)).astype(np.float32)
    cot = np.random.default_rng(9).standard_normal((2, 150, cfg.d_model)).astype(np.float32)
    leaves = tree_paths(p)
    tp = tree_map(lambda _, t: t.detach().clone().requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, h = S.ssm(tp, tx, cfg, chunk=cfg.q_chunk)
    loss = (out * torch.from_numpy(cot)).sum() + h.sum()
    tl = tree_paths(tp)
    g = torch.autograd.grad(loss, [tx] + [tl[n] for n in leaves])

    def jloss(jp, jx_):
        o, hh = jS.ssm(jp, jx_, cfg, chunk=cfg.q_chunk)
        return jnp.sum(o * cot) + jnp.sum(hh), (o, hh)

    (_, (jo, jh)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(_jx(p), jnp.asarray(x))
    _close(out, jo, "ssm out")
    _close(h, jh, "ssm final h")
    _close(g[0], jgx, "grad x")
    jgp = j_tree_paths(jgp)
    for n, gn in zip(leaves, g[1:]):
        _close(gn, jgp[n], f"grad {n}")


def test_ssm_decode_steps_match_full_forward():
    """Stepping ``ssm_decode`` token by token from the zero state gives the
    full forward's outputs (over chunks of 8) and its final h; the conv
    state ends holding the last 3 pre-conv inputs (one row's product
    against the whole prompt's: equal up to the matmul's order)."""
    cfg, p = _ssm_params()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full, h, u = S.ssm(p, x, cfg, chunk=8, with_u=True)
        st = S.init_ssm_state(cfg, 2, "cpu")
        outs = []
        for t in range(x.shape[1]):
            o, st = S.ssm_decode(p, x[:, t:t + 1], st, cfg)
            outs.append(o)
    _close(torch.cat(outs, 1), full.numpy(), "ssm decode outputs")
    _close(st["h"], h.numpy(), "ssm decode final h")
    _close(st["conv"], u[:, -3:].numpy(), "ssm decode conv state")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _batch(seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (B, S)).astype(np.int32),
            rng.integers(0, 128, (B, S)).astype(np.int32))


_REF = {}


def _ref(key, fn):
    """The reference's result for ``key``, computed once: the masked and
    block-sparse modes share one topology, so one reference run (w * m)
    serves both."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_forward_and_grads_match_reference(mode):
    """``lm_forward``'s hidden states, the loss and the gradient of every
    leaf (the tied table's: the gather's and the head's summed; the SSM's
    bare leaves) on the reference's weights.  The kernel modes' weight
    gradients are the masked ones, zero outside the mask."""
    jcfg, cfg, params, masks, pack = _state(mode)
    toks, tgt = _batch(5, S=32)  # past the smoke window (16)
    jm = None if mode == "dense" else _jx(masks)
    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}

    def reference():
        def f(p):  # lm_forward's hidden states once: masks change no code path
            hid = j_lm_forward(p, jcfg, batch)[0] if jm is None else None
            return j_lm_loss(p, jcfg, batch, masks=jm), hid

        (loss, hid), g = jax.jit(jax.value_and_grad(f, has_aux=True))(_jx(params))
        return hid, loss, j_tree_paths(g)

    jh, want, jg = _ref(("loss", mode == "dense"), reference)
    tb = {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgt).long()}
    tmasks = None if mode == "dense" else masks
    if jh is not None:
        with torch.no_grad():
            hid, _, _ = tm.lm_forward(params, cfg, tb, collect_states=False)
        _close(hid, jh, "lm_forward hidden")
    leaves = tree_paths(params)
    tp = tree_map(lambda _, t: t.clone().requires_grad_(True), params)
    loss = tm.lm_loss(tp, cfg, tb, masks=tmasks, pack=pack)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    tl = tree_paths(tp)
    grads = dict(zip(leaves, torch.autograd.grad(loss, [tl[n] for n in leaves])))
    mflat = tree_paths(masks)
    assert {"embed/table", "layers/0/ssm/a_log", "layers/0/ssm/conv/w",
            "layers/3/ssm/out_proj/w"} <= grads.keys()
    for n, g in grads.items():
        _close(g, jg[n], f"{mode} grad {n}")
        if n in mflat and mode != "dense":
            assert float(g[~mflat[n]].abs().max()) == 0.0, n
