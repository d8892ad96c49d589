"""Port grok-1-314b vs the JAX package on its smoke config.

grok is the only config with bf16 parameters, bf16 gradient accumulation
and a final logit softcap; the train CLI's Adam meets it with a bf16
state.  Both packages run the SMOKE config with ``param_dtype='bfloat16'``,
``grad_accum_dtype='bfloat16'`` and ``microbatches=2`` replaced
identically (and grok's ``loss_chunks=4`` where the loss's chunking is
held); the reference's train state comes across through ``bridge.py``
(bf16 leaves keep their bits), inputs are made from numpy seeds, the port
runs its kernels' plain versions on the CPU and the reference its Pallas
kernels in interpret mode.

Tolerances.  f32 values computed in another order: 1e-5 of the largest
magnitude at one product, 1e-4 through the model (the other slices').  A
bf16 result (params after an update, bf16 momenta, bf16 gradients) is
held within one bf16 ulp of the largest value (``_ulp_close``), not bit
for bit: each rounding point may see an f32 sum one rounding apart (XLA's
CPU code may also keep a fused ``g + wd * w`` in f32 and round once where
torch rounds after each op), so an element may land one ulp away.  Each
use names the tensor it holds.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm_forward as j_lm_forward  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models.model import _embed_inputs as j_embed, _logits as j_logits  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.optim import apply_opt as j_apply_opt  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.training import init_train_state, make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core import rigl as trigl  # noqa: E402
from repro_torch.core.masks import tree_paths  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.optim.optimizers import apply_opt as t_apply_opt  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

ARCH = "grok-1-314b"
BLOCK = 16
BLK = (128, BLOCK, BLOCK)
MODES = {
    "dense": dict(sparsity=0.8, method="rigl", kernel="dense", attn_kernel="flash_tight"),
    "block_sparse": dict(sparsity=0.8, method="rigl", kernel="block_sparse",
                         block_shape=(BLOCK, BLOCK), kernel_block=BLK,
                         attn_kernel="flash_tight"),
    "masked": dict(sparsity=0.8, method="rigl", kernel="masked", attn_kernel="flash_tight"),
}
GROK = dict(param_dtype="bfloat16", grad_accum_dtype="bfloat16", microbatches=2)
LR = dict(kind="constant", base_lr=0.05)
SGD = dict(kind="sgd", momentum=0.9, weight_decay=1e-4, state_dtype="bfloat16")
B, S = 4, 16  # two microbatches of 2 x 16 tokens


def _configs(mode, attn="flash_tight", **kw):
    """Both packages' smoke configs in ``mode``; ``attn`` 'dense' runs the
    plain attention (its softcap too) where a test holds the train step,
    not the flash kernels (their interpret-mode compile costs seconds)."""
    kw = {**GROK, **kw}
    sp = dict(MODES[mode], attn_kernel=attn)
    return (dataclasses.replace(get_config(ARCH, smoke=True), sparse=SparseConfig(**sp), **kw),
            dataclasses.replace(t_get_config(ARCH, smoke=True), sparse=TSparse(**sp), **kw))


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _bridge(st):
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st.get("pack"), is_leaf=is_pack_entry)
    opt = {k: (int(v) if k == "count" else _flat(v)) for k, v in st["opt"].items()}
    return bridge.train_state_from_flat(
        _flat(st["params"]), _flat(st["masks"]),
        bwd_masks=_flat(st["bwd_masks"]) if "bwd_masks" in st else None,
        pack={path_name(p): e for p, e in flat_k if e is not None} if "pack" in st else None,
        opt=opt, step=int(st["step"]), device="cpu")


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


def _ulp_close(got, want, what, ulps=1):
    """Within ``ulps`` bf16 ulps of the largest |want| (8 significant
    bits): one for each bf16 rounding the value passed through."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max(initial=0.0))
    ulp = ulps * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= ulp, f"{what}: max |port - jax| = {err} > {ulps} bf16 ulp(s) {ulp} of {top}"


def _batch(jcfg, step, b=B):
    jb = batch_for(jcfg, step, b, S, learnable=True)
    return jb, {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}


_STATES = {}


def _state(mode, attn="flash_tight"):
    """The reference's RigL train state (bf16 masters, bf16 SGD momentum,
    ERK 0.8, seed 0) and its bridge, once per mode and attention."""
    if (mode, attn) not in _STATES:
        jcfg, tcfg = _configs(mode, attn)
        st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig(**SGD))
        _STATES[mode, attn] = (jcfg, st), (tcfg, _bridge(st))
    return _STATES[mode, attn]


def test_bf16_masters_and_the_f32_residual():
    """``init_lm`` under ``param_dtype='bfloat16'`` gives bf16 leaves only,
    as the reference's ``init_train_state`` (norm scales, router, embed and
    head included); the embedding's sqrt(d_model) scale promotes the
    residual to f32 in both packages."""
    (jcfg, st), (tcfg, tst) = _state("block_sparse")
    params, _ = tm.init_lm(tcfg, 0, device="cpu")
    assert {t.dtype for t in tree_paths(params).values()} == {torch.bfloat16}
    assert tree_paths(params)["layers/0/moe/wi/w"].shape == (4, 64, 64)
    assert {str(a.dtype) for a in _flat(st["params"]).values()} == {"bfloat16"}
    assert {t.dtype for t in tree_paths(tst["params"]).values()} == {torch.bfloat16}
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jx = j_embed(st["params"], jcfg, {"tokens": jnp.asarray(toks)})
    tx = tm._embed(tst["params"], tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert jx.dtype == jnp.float32 and tx.dtype == torch.float32
    _close(tx, jx, 0.0, "embedded residual")


@pytest.mark.parametrize("mode", ["block_sparse"])
def test_forward_logits_with_final_softcap_match_reference(mode):
    """The full forward on the bridged state (bf16 attention, the f32 MoE
    over bf16 banks, the bf16 head upcast) and the head's logits after the
    final softcap: within one bf16 ulp of the largest logit (the logits
    are f32, but each layer adds a bf16 attention output to the residual,
    and flash's output rounding may land one ulp apart between the plain
    version and the interpret-mode kernel), every one below the cap; the
    pad slots -1e30.  ``lm_loss`` under grok's ``loss_chunks=4`` (the
    final softcap applied chunk by chunk) within two bf16 ulps of the
    largest logit: a position's cross-entropy moves by at most twice its
    logits' largest change, and so does their mean."""
    (jcfg, st), (tcfg, tst) = _state(mode)
    jb, tb = _batch(jcfg, 0, 2)
    jh = jax.jit(lambda p, m, k: j_logits(p, jcfg, j_lm_forward(
        p, jcfg, jb, masks=m, pack=k)[0]))(st["params"], st["masks"], st.get("pack"))
    with torch.no_grad():
        h = tm.lm_forward(tst["params"], tcfg, tb, masks=tst["masks"],
                          pack=tst.get("pack"), collect_states=False)[0]
        got = tm._logits(tst["params"], tcfg, h)
    assert h.dtype == torch.float32 and got.dtype == torch.float32
    V = jcfg.vocab_size
    _ulp_close(got[..., :V], np.asarray(jh)[..., :V], f"{mode} logits")
    assert float(got[..., :V].abs().max()) < jcfg.final_softcap
    assert bool((got[..., V:] == -1e30).all())
    jc, tc = (dataclasses.replace(c, loss_chunks=4) for c in (jcfg, tcfg))
    jloss = jax.jit(lambda p, m, k: j_lm_loss(p, jc, jb, masks=m, pack=k))(
        st["params"], st["masks"], st.get("pack"))
    with torch.no_grad():
        tloss = tm.lm_loss(tst["params"], tc, tb, masks=tst["masks"], pack=tst.get("pack"))
    top = float(np.abs(np.asarray(jh)[..., :V]).max())
    err = abs(float(tloss) - float(jloss))
    assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), f"{mode} loss, 4 chunks: {err}"


@pytest.mark.parametrize("mode", ["dense", "block_sparse", "masked"])
def test_train_step_matches_reference(mode):
    """One train step (2 microbatches accumulated in bf16, SGD with a bf16
    momentum and weight decay, constant lr 0.05) in each kernel mode: the
    loss within 1e-4, every param and momentum leaf stays bf16: the params
    within one bf16 ulp of the largest value of the reference's (their one
    rounding), the momenta within four (each microbatch's bf16 gradient,
    their bf16 sum and the decay's bf16 add each round once; the embedding
    table's gradient is a bf16 scatter-add besides).  Plain attention
    (``_configs``)."""
    (jcfg, st), (tcfg, tst) = _state(mode, "dense")
    jb, tb = _batch(jcfg, 0)
    jst, jm = jax.jit(make_train_step(jcfg, OptConfig(**SGD), LRSchedule(**LR)))(st, jb)
    # the step updates in place: a copy keeps the shared state fresh
    tst2, tmet = tsteps.make_train_step(tcfg, TOpt(**SGD), TLR(**LR))(copy.deepcopy(tst), tb)
    _close(tmet["loss"], jm["loss"], 1e-4, f"{mode} loss")
    for what, got, want in (("params", tst2["params"], jst["params"]),
                            ("momentum", tst2["opt"]["momentum"], jst["opt"]["momentum"])):
        want = _flat(want)
        got = tree_paths(got)
        assert sorted(got) == sorted(want)
        for n, t in got.items():
            assert t.dtype == torch.bfloat16, (what, n)
            _ulp_close(t, want[n], f"{mode} {what} {n}", 1 if what == "params" else 4)


def test_adam_bf16_state_returns_f32_moments():
    """Adam from a bf16 state, the reference's ``apply_opt`` on the same bf16
    params and gradients: after step 1 the port's moments are f32 tensors
    (the reference returns f32 arrays), m and v within 1e-6 of the
    reference's, the bf16 params within one bf16 ulp of the largest; step 2
    from those f32 moments likewise.  A skipped step (non-finite guard)
    keeps the old bf16 values, promoted."""
    rng = np.random.default_rng(11)
    shapes = {"a": (6, 5), "b": (3, 4, 8)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    cfg = dict(kind="adam", weight_decay=1e-4, state_dtype="bfloat16")
    jopt, topt = OptConfig(**cfg), TOpt(**cfg)
    jst = {"m": {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()},
           "v": {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()},
           "count": jnp.zeros((), jnp.int32)}
    tst = {"m": {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()},
           "v": {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()},
           "count": torch.zeros((), dtype=torch.int32)}
    # the moments cross the bridge both ways in their dtype: bf16 before the
    # first update, f32 after it
    for k in ("m", "v"):
        tst[k] = bridge.params_from_flat({n: np.asarray(a) for n, a in jst[k].items()}, "cpu")
        back = bridge.flat_of(tst[k])
        assert {str(a.dtype) for a in back.values()} == {"bfloat16"}
    for step in range(2):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, jst = j_apply_opt(jopt, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
                              jst, jp, 0.01)
        t_apply_opt(topt, {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()},
                    tst, tp, 0.01)
        for k in shapes:
            assert tst["m"][k].dtype == tst["v"][k].dtype == torch.float32
            assert jst["m"][k].dtype == jnp.float32
            _close(tst["m"][k], jst["m"][k], 1e-6, f"step {step} m {k}")
            _close(tst["v"][k], jst["v"][k], 1e-6, f"step {step} v {k}")
            assert tp[k].dtype == torch.bfloat16
            _ulp_close(tp[k], jp[k], f"step {step} params {k}")  # bf16 params
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        for k in ("m", "v"):
            back = bridge.flat_of(tst[k])
            for n, a in back.items():
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, _np(tst[k][n]))
    # the guard: a skipped first step keeps the zeros, promoted to f32
    fresh = {"m": {"a": torch.full((2, 2), 0.3, dtype=torch.bfloat16)},
             "v": {"a": torch.zeros((2, 2), dtype=torch.bfloat16)},
             "count": torch.zeros((), dtype=torch.int32)}
    w = {"a": torch.ones((2, 2), dtype=torch.bfloat16)}
    t_apply_opt(topt, {"a": torch.ones((2, 2), dtype=torch.bfloat16)}, fresh, w, 0.01,
                ok=torch.tensor(False))
    assert fresh["m"]["a"].dtype == torch.float32
    assert torch.equal(fresh["m"]["a"], torch.full((2, 2), 0.3, dtype=torch.bfloat16).float())
    assert torch.equal(w["a"], torch.ones((2, 2), dtype=torch.bfloat16))


def test_checkpoint_restore_casts_f32_moments_to_the_template(tmp_path):
    """A checkpoint holding Adam's f32 moments (the state after step 1),
    restored into a fresh state's template with bf16 moments, is cast to
    the template's dtype in both packages (the reference's
    ``checkpoint.py:218``, the port's ``_leaf``): the same bf16 bits, the
    f32 values rounded once.  Mirrored as the reference does it, not
    repaired."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((4, 8)).astype(np.float32)
    tstate = {"params": {"w": torch.from_numpy(m).to(torch.bfloat16)},
              "opt": {"m": {"w": torch.from_numpy(m)}, "count": torch.tensor(1)}}
    tckpt.save(tstate, tmp_path / "t", 1)
    like = {"params": {"w": torch.zeros((4, 8), dtype=torch.bfloat16)},
            "opt": {"m": {"w": torch.zeros((4, 8), dtype=torch.bfloat16)},
                    "count": torch.tensor(0)}}
    got, step = tckpt.restore(like, tmp_path / "t")
    # (the reference's own npz round trip cannot read a bf16 leaf back:
    # its tree holds the moments alone)
    jstate = {"opt": {"m": {"w": jnp.asarray(m)}, "count": jnp.int32(1)}}
    jckpt.save(jstate, tmp_path / "j", 1)
    jlike = {"opt": {"m": {"w": jnp.zeros((4, 8), jnp.bfloat16)}, "count": jnp.int32(0)}}
    jgot, _ = jckpt.restore(jlike, tmp_path / "j")
    assert step == 1 and got["opt"]["m"]["w"].dtype == torch.bfloat16
    assert jgot["opt"]["m"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got["opt"]["m"]["w"]), _np(jgot["opt"]["m"]["w"]))
    assert torch.equal(got["opt"]["m"]["w"], torch.from_numpy(m).to(torch.bfloat16))


def test_bf16_grads_on_f32_masters_matches_reference():
    """``bf16_grads`` on f32 masters (one downcast before the loss: the
    forward reads the bf16 values, the cotangents come back bf16), dense,
    one microbatch, SGD with an f32 momentum: the loss within 1e-4, the
    f32 momentum within three bf16 ulps of its largest value (it holds the
    bf16 gradient, rounded once, plus the decay's bf16 add, rounded again
    in the port, where XLA's excess precision may keep the sum in f32),
    the f32 params within 1e-5."""
    jcfg, tcfg = _configs("dense", "dense", param_dtype="float32", bf16_grads=True,
                          microbatches=1)
    opt = dict(SGD, state_dtype="float32")
    st, _, _ = init_train_state(jax.random.PRNGKey(1), jcfg, OptConfig(**opt))
    tst = _bridge(st)
    assert {t.dtype for t in tree_paths(tst["params"]).values()} == {torch.float32}
    jb, tb = _batch(jcfg, 1, 2)
    jst, jm = jax.jit(make_train_step(jcfg, OptConfig(**opt), LRSchedule(**LR)))(st, jb)
    tst, tmet = tsteps.make_train_step(tcfg, TOpt(**opt), TLR(**LR))(tst, tb)
    _close(tmet["loss"], jm["loss"], 1e-4, "bf16_grads loss")
    want_m, want_p = _flat(jst["opt"]["momentum"]), _flat(jst["params"])
    for n, t in tree_paths(tst["opt"]["momentum"]).items():
        assert t.dtype == torch.float32
        _ulp_close(t, want_m[n], f"bf16_grads momentum {n}", 3)
    for n, t in tree_paths(tst["params"]).items():
        _close(t, want_p[n], 1e-5, f"bf16_grads params {n}")


def test_fused_gate_under_one_and_sixteen_microbatches():
    """The fused SGD epilogue with bf16 masters and a bf16 momentum (its
    stochastic rounding): accepted under ``microbatches=1`` by both
    packages, refused under grok's 16 with the reference's wording.  The
    port's fused step then runs K7/K8 on the bf16 masters (upcast inside
    their Functions): a finite loss, bf16 params and momenta, the banks'
    momenta zero off their supersets."""
    sp = dict(MODES["block_sparse"], fused_epilogue=True)
    opt = dict(SGD, grad_clip=0.0)
    for mb in (1, 16):
        jcfg = dataclasses.replace(get_config(ARCH, smoke=True), sparse=SparseConfig(**sp),
                                   **{**GROK, "microbatches": mb})
        tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), sparse=TSparse(**sp),
                                   **{**GROK, "microbatches": mb})
        if mb == 16:
            with pytest.raises(ValueError, match="microbatches"):
                make_train_step(jcfg, OptConfig(**opt), LRSchedule(**LR))
            with pytest.raises(ValueError, match="microbatches"):
                tsteps.make_train_step(tcfg, TOpt(**opt), TLR(**LR))
            continue
        make_train_step(jcfg, OptConfig(**opt), LRSchedule(**LR))
        step = tsteps.make_train_step(tcfg, TOpt(**opt), TLR(**LR))
        st, _ = tsteps.init_train_state(tcfg, TOpt(**opt), seed=0, device="cpu")
        st, met = step(st, _batch(jcfg, 0, 2)[1])
        assert bool(torch.isfinite(met["loss"]))
        for tree in (st["params"], st["opt"]["momentum"]):
            assert {t.dtype for t in tree_paths(tree).values()} == {torch.bfloat16}
        bwd = tree_paths(st["bwd_masks"])
        for n, mo in tree_paths(st["opt"]["momentum"]).items():
            if "/moe/w" in n:
                assert not mo[~bwd[n]].any(), n


def test_paged_engine_streams_match_reference():
    """The paged engine under block_sparse on the bridged bf16 masters
    (the banks and head upcast per call) gives the reference engine's
    greedy tokens; the prefix cache is refused for an MoE config, as the
    reference's ``_share_ok`` refuses it."""
    (jcfg, st), (tcfg, tst) = _state("block_sparse")
    req = dict(prompt_lens=(5, 12), gen_lens=(5, 3, 4))
    jreqs, treqs = j_requests(jcfg, 3, **req), t_requests(tcfg, 3, **req)
    kw = dict(capacity=2, max_len=32, paged=True, page_size=8)
    for Engine, cfg, s, reqs in ((JEngine, jcfg, st, jreqs), (TEngine, tcfg, tst, treqs)):
        engine = Engine(cfg, s["params"], masks=s["masks"], pack=s["pack"], **kw)
        for r in reqs:
            assert engine.submit(r)
        while len(engine.queue) or engine.active.any():
            engine.step(now=0.0)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert len({t for r in jreqs for t in r.generated}) > 3
    with pytest.raises(ValueError, match="prefix_cache"):
        TEngine(tcfg, tst["params"], masks=tst["masks"], pack=tst["pack"],
                prefix_cache=2, **kw)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_block_sparse_without_a_pack_entry_matches_reference(wdtype):
    """``linear`` and ``grouped_linear`` under kernel='block_sparse' with a
    mask and no PackState entry pack the mask's blocks on the call, as the
    reference's ``_block_mask`` path: the output within 1e-5 of the
    reference's (f32 compute; a bf16 weight upcast, grok's head and
    banks), the gradients of x and w too (w's in its own dtype: a bf16
    cotangent within one bf16 ulp of the largest), and bit for bit the
    call with a prebuilt entry."""
    rng = np.random.default_rng(21)
    K, N, G, M = 64, 48, 3, 10
    bm2 = rng.random((K // BLOCK, N // BLOCK)) < 0.5
    bm2[0, 0] = True
    bm3 = rng.random((G, K // BLOCK, N // BLOCK)) < 0.5
    bm3[:, 0, 0] = True
    for mask_b, shape_x in ((bm2, (2, M, K)), (bm3, (G, M, K))):
        mask = np.repeat(np.repeat(mask_b, BLOCK, -2), BLOCK, -1)
        w = (rng.standard_normal(mask.shape) * mask).astype(np.float32)
        x = rng.standard_normal(shape_x).astype(np.float32)
        g = rng.standard_normal(shape_x[:-1] + (N,)).astype(np.float32)
        jw = jnp.asarray(w, getattr(jnp, wdtype))
        tw = torch.from_numpy(w).to(getattr(torch, wdtype)).requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        tmask = torch.from_numpy(mask)
        grouped = mask.ndim == 3
        if grouped:
            jfn = lambda a, b: jl.grouped_linear(b, a, jnp.float32, mask=jnp.asarray(mask),
                                                 kernel="block_sparse", block=BLK)
            tfn = lambda a, b, pk: tl.grouped_linear(b, a, torch.float32, mask=tmask,
                                                     kernel="block_sparse", block=BLK, pack=pk)
        else:
            jfn = lambda a, b: jl.linear({"w": b}, a, jnp.float32, mask=jnp.asarray(mask),
                                         kernel="block_sparse", block=BLK)
            tfn = lambda a, b, pk: tl.linear({"w": b}, a, torch.float32, mask=tmask,
                                             kernel="block_sparse", block=BLK, pack=pk)
        jy, pull = jax.vjp(jfn, jnp.asarray(x), jw)
        jdx, jdw = pull(jnp.asarray(g))
        ty = tfn(tx, tw, None)
        tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
        what = f"{'grouped_linear' if grouped else 'linear'} {wdtype}"
        _close(ty, jy, 1e-5, f"{what} y")
        _close(tdx, jdx, 1e-5, f"{what} dx")
        assert tdw.dtype == tw.dtype
        if wdtype == "bfloat16":
            _ulp_close(tdw, jdw, f"{what} dw")  # the cotangent rounded to bf16
        else:
            _close(tdw, jdw, 1e-5, f"{what} dw")
        entry = tpack.pack_entry(tmask, (BLOCK, BLOCK))
        with torch.no_grad():
            assert torch.equal(tfn(tx, tw, None), tfn(tx, tw, entry))


def test_exact_selection_equals_the_ranks(monkeypatch):
    """``rigl.select_top`` (the elementwise top-n of a layer of at least
    ``SELECT_MIN`` units: grok's 1.61 G-element banks under masked) equals
    ``_rank_desc(x) < n`` bit for bit, on draws with ties, signed zeros,
    infinities and NaN; and the superset draw and the drop/grow give the
    same masks through it as through the ranks."""
    rng = np.random.default_rng(7)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.5, np.inf, -np.inf, np.nan], np.float32)
    for trial in range(60):
        n_el = int(rng.integers(1, 400))
        x = (rng.standard_normal(n_el).astype(np.float32) if trial % 3 == 0 else
             rng.integers(-4, 5, n_el).astype(np.float32) if trial % 3 == 1 else
             rng.choice(pool, n_el))
        t = torch.from_numpy(x)
        for n in {0, 1, n_el // 3, n_el - 1, n_el, n_el + 3, int(rng.integers(0, n_el + 1))}:
            want = trigl._rank_desc(t) < n
            assert torch.equal(trigl.select_top(t, torch.tensor(n, dtype=torch.int32)), want)
    w = torch.from_numpy((rng.standard_normal((4, 64, 48)) *
                          (rng.random((4, 64, 48)) < 0.3)).astype(np.float32))
    mask = w != 0
    score = torch.from_numpy(rng.integers(0, 3, (4, 64, 48)).astype(np.float32))
    frac = torch.tensor(0.3)
    runs = []
    for select_min in (trigl.SELECT_MIN, 1):
        monkeypatch.setattr(trigl, "SELECT_MIN", select_min)
        gen = torch.Generator().manual_seed(3)
        b = trigl.topkast_superset_layer(w, mask, 0.1, gen)
        runs.append((b,) + trigl.rigl_update_layer(w, mask, score, frac)[::2])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert bool((runs[0][1] != mask).any())  # the drop/grow moved something
