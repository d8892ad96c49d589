"""Port gemma3 (gemma3-4b) vs the JAX package on the smoke config, block 16.

Covers the slice bottom up: the config copy; the init layout (``q_norm``,
``k_norm``, ``ln1_post`` and ``ln2_post`` present and dense) and the ERK
map; ``serving_weights`` keeping the qk-norm scales f32; GeGLU against the
reference's ``mlp`` (tanh gelu); qk-norm attention, full-sequence and
decode; ``lm_forward``, ``lm_loss`` and its gradients (the tied table's
included) under dense, masked and block_sparse; prefill and decode; the
engine's greedy streams, contiguous and paged (a local ring pool and a
global pool); the prefix cache refused (local layers); the CLIs; and the
plain flash at head_dim 256 (K9-K11's plain versions through
``flash_attention``) against the reference's ``flash_attention`` in
interpret mode, forward and gradients.

The weights are the reference's own init (seed 0) carried by ``bridge``,
the port's 16x16-block ERK masks applied to them (one topology for every
mode); the port's kernel modes run their kernels' plain versions on the
CPU, the reference runs kernel='dense' with the same masks (``w * m``).
Tolerances, relative to the largest magnitude compared: 1e-4 for f32
results (sums in another order); 5e-3 for the bf16 config's logits (bf16
attention); the flash cases at head_dim 256 in bf16 take 2**-6 (the
kernels' p and ds rounded to bf16 at the same points, summed in another
order), as ``test_torch_flash_bwd_plan.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_forward as j_lm_forward  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.models import mlp as jM  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.training.steps import sparsity_map as j_sparsity_map  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.distributions import sparsity_map  # noqa: E402
from repro_torch.core.masks import apply_masks, init_masks, tree_map, tree_paths  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import configure_kernel  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

ARCH = "gemma3-4b"
BLOCK = 16
TOL = 1e-4
MODES = ("dense", "masked", "block_sparse")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one CPU thread while this module runs: its ops are tiny,
    and several test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _cfgs(arch, dtype="float32"):
    """(reference config, port config) of the smoke model at ``dtype``:
    ERK 0.8, the reference dense (``w * m``), the port block-sparse."""
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                               sparse=SparseConfig(sparsity=0.8, kernel="dense"))
    tcfg = configure_kernel(dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype),
                            kernel="block_sparse", block=BLOCK)
    return jcfg, tcfg


_STATES = {}


def _state(arch, mode, dtype="float32"):
    """The reference's init weights (seed 0), carried into the port by
    ``bridge``; the port's 16x16-block ERK masks (one topology for every
    mode) applied to them; the pack under block_sparse.  Cached per (arch,
    dtype): the bf16 state shares the f32 masters."""
    key = (arch, dtype)
    if key not in _STATES and dtype != "float32":
        _, _, params, masks, pack = _state(arch, "block_sparse")
        _STATES[key] = (*_cfgs(arch, dtype), params, masks, pack)
    if key not in _STATES:
        jcfg, cfg = _cfgs(arch, dtype)
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


_REF = {}


def _ref(key, fn):
    """The reference's result for ``key``, computed once: the masked and
    block-sparse modes share one topology, so one reference run (w * m)
    serves both."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


# --------------------------------------------------------------------------
# config, init, ERK, serving weights (shared with test_torch_parallel_block)
# --------------------------------------------------------------------------

def config_matches(arch):
    for smoke in (False, True):
        assert (dataclasses.asdict(t_get_config(arch, smoke=smoke))
                == dataclasses.asdict(get_config(arch, smoke=smoke)))


def init_layout_matches(arch, smoke):
    """Paths, shapes and sparse flags of the reference's tree and the same
    ERK map; the full config on shapes alone.  Returns the reference's
    shapes and flags."""
    sp = SparseConfig(sparsity=0.8, distribution="erk")
    jcfg = dataclasses.replace(get_config(arch, smoke=smoke), sparse=sp)
    tcfg = t_get_config(arch, smoke=smoke)
    box = {}

    def init(key):
        params, _, box["flags"] = j_init_lm(key, jcfg)
        return params

    shapes = j_tree_paths(jax.eval_shape(init, jax.random.PRNGKey(0)))
    flags = j_tree_paths(box["flags"])
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
    for n in want:
        assert got[n] == pytest.approx(want[n], abs=1e-12), n
    return shapes, flags


def test_config_copy_matches_reference():
    config_matches(ARCH)
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff) == (34, 2560, 8, 4, 256, 10240)
    assert [full.layer_kind(i) for i in range(7)] == ["local"] * 5 + ["global", "local"]
    assert tm.padded_vocab(full) == 262144 and full.tie_embeddings and full.qk_norm


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """The qk-norm scales (head_dim wide) and both post-norms in every
    layer, dense; ``ln2`` too (a sequential block)."""
    shapes, flags = init_layout_matches(ARCH, smoke)
    assert "head/w" not in shapes  # tied
    hd = t_get_config(ARCH, smoke=smoke).head_dim
    for leaf in ("attn/q_norm/scale", "attn/k_norm/scale", "ln1_post/scale",
                 "ln2_post/scale", "ln2/scale"):
        n = f"layers/0/{leaf}"
        assert n in shapes and not flags[n], n
    assert tuple(shapes["layers/0/attn/q_norm/scale"].shape) == (hd,)


def test_serving_weights_keep_qk_norm_scales_f32():
    """``serving_weights`` casts the attention projections to the compute
    dtype and leaves the qk-norm scales as they are (f32, as the
    reference's rmsnorm reads them)."""
    _, cfg, params, _, _ = _state(ARCH, "block_sparse", "bfloat16")
    w = tm.serving_weights(params, cfg)
    attn = w["layers"][0]["attn"]
    assert {attn[n]["w"].dtype for n in ("wq", "wk", "wv", "wo")} == {torch.bfloat16}
    for n in ("q_norm", "k_norm"):
        assert attn[n]["scale"].dtype == torch.float32
        assert attn[n]["scale"] is params["layers"][0]["attn"][n]["scale"]


# --------------------------------------------------------------------------
# GeGLU and qk-norm attention
# --------------------------------------------------------------------------

def test_geglu_matches_reference():
    """GeGLU (tanh gelu, as ``jax.nn.gelu``'s default) on dense weights
    drawn with numpy, and under the masked kernel mode on layer 1's masks
    (the reference's dense ``mlp`` on w * m), f32."""
    _, cfg, _, masks, _ = _state(ARCH, "masked")
    rng = np.random.default_rng(2)
    d, f = cfg.d_model, cfg.d_ff
    p = {n: {"w": torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32))}
         for n, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    m = masks["layers"][1]["mlp"]
    x = torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
    with torch.no_grad():
        got = M.mlp(p, x, "geglu")
        got_m = M.mlp(p, x, "geglu", masks=m, kernel="masked")
        swiglu = M.mlp(p, x, "swiglu")
    _close(got, jM.mlp(_jx(p), jnp.asarray(x.numpy()), "geglu"), "geglu")
    pm = {n: {"w": p[n]["w"] * m[n]["w"]} for n in p}
    _close(got_m, jM.mlp(_jx(pm), jnp.asarray(x.numpy()), "geglu"), "geglu masked")
    assert float((got - swiglu).abs().max()) > 1e-2  # another gate


def test_qk_norm_attention_matches_reference():
    """Full-sequence attention of a local and the global layer (q and k
    rmsnormed over head_dim before RoPE) on non-unit qk-norm scales,
    against the reference's ``attention``, dense, f32, past the smoke
    window (the bf16 config's qk-norm runs in the prefill and decode
    cases)."""
    tol = TOL
    jcfg, cfg, params, _, _ = _state(ARCH, "dense")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    for i in (1, 5):
        p = dict(params["layers"][i]["attn"])
        for n in ("q_norm", "k_norm"):
            p[n] = {"scale": torch.from_numpy(
                rng.uniform(0.5, 1.5, cfg.head_dim).astype(np.float32))}
        kind = cfg.layer_kind(i)
        with torch.no_grad():
            got, _ = A.attention(p, torch.from_numpy(x), cfg, kind=kind)
        want, _ = jA.attention(_jx(p), jnp.asarray(x), jcfg, kind=kind)
        _close(got, np.asarray(jnp.asarray(want, jnp.float32)), f"attention layer {i}", tol)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def batch(seed, vocab, B=2, S=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def loss_and_grads_match(arch, mode, extra_leaves=()):
    """``lm_forward``'s hidden states (dense), the loss and the gradient of
    every leaf (the tied table's: the gather's and the head's summed) on
    the reference's weights; the kernel modes' weight gradients are the
    masked ones, zero outside the mask."""
    jcfg, cfg, params, masks, pack = _state(arch, mode)
    toks, tgt = batch(5, cfg.vocab_size, S=32)  # past the smoke window (16)
    jm = None if mode == "dense" else _jx(masks)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}

    def reference():
        def f(p):
            hid = j_lm_forward(p, jcfg, jb)[0] if jm is None else None
            return j_lm_loss(p, jcfg, jb, masks=jm), hid

        (loss, hid), g = jax.jit(jax.value_and_grad(f, has_aux=True))(_jx(params))
        return hid, loss, j_tree_paths(g)

    jh, want, jg = _ref((arch, "loss", mode == "dense"), reference)
    tb = {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgt).long()}
    if jh is not None:
        with torch.no_grad():
            hid, _, _ = tm.lm_forward(params, cfg, tb, collect_states=False)
        _close(hid, jh, "lm_forward hidden")
    leaves = tree_paths(params)
    tp = tree_map(lambda _, t: t.clone().requires_grad_(True), params)
    loss = tm.lm_loss(tp, cfg, tb, masks=None if mode == "dense" else masks, pack=pack)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    tl = tree_paths(tp)
    grads = dict(zip(leaves, torch.autograd.grad(loss, [tl[n] for n in leaves])))
    mflat = tree_paths(masks)
    assert {"embed/table", "layers/0/attn/wq/w", *extra_leaves} <= grads.keys()
    for n, g in grads.items():
        _close(g, jg[n], f"{mode} grad {n}")
        if n in mflat and mode != "dense":
            assert float(g[~mflat[n]].abs().max()) == 0.0, n


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_forward_and_grads_match_reference(mode):
    loss_and_grads_match(ARCH, mode, ("layers/0/attn/q_norm/scale", "layers/5/ln2_post/scale"))


def prefill_decode_match(arch, mode, dtype, tol, prompt_lens=(5, 20)):
    """Two slots admitted (``prompt_lens``) into shared contiguous caches,
    then 4 decode steps, slot 0 inactive for the last two: prefill and
    decode logits against the reference's ``lm_prefill_into`` and
    ``lm_decode`` (greedy tokens fed back), the inactive slot's KV bit for
    bit unchanged."""
    jcfg, cfg, params, masks, pack = _state(arch, mode, dtype)
    max_len = 32
    prompts = [np.random.default_rng(20 + s).integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
               for s, n in enumerate(prompt_lens)]
    actives = [np.array([step < 2, True]) for step in range(4)]

    def reference():
        jp, jm = _jx(params), _jx(masks)
        jc = j_init_caches(jcfg, 2, max_len)
        pre = []
        for slot, prompt in enumerate(prompts):
            jl, jc = jax.jit(lambda c, t, s_: j_lm_prefill_into(
                jp, jcfg, c, {"tokens": t}, s_, max_len, masks=jm))(
                jc, jnp.asarray(prompt), slot)
            pre.append(np.asarray(jl))
        j_dec = jax.jit(lambda c, t, pos, act: j_lm_decode(
            jp, jcfg, c, t, pos, masks=jm, active=act))
        cur = np.array([int(np.argmax(jl[0, -1])) for jl in pre])
        pos = np.array(prompt_lens, np.int32)
        steps = []
        for active in actives:
            jl, jc = j_dec(jc, jnp.asarray(cur)[:, None], jnp.asarray(pos), jnp.asarray(active))
            steps.append((cur, pos.copy(), np.asarray(jl)))
            cur = np.where(active, np.argmax(np.asarray(jl)[:, -1], -1), cur)
            pos = pos + active
        return pre, steps

    pre, steps = _ref((arch, "serve", mode == "dense", dtype), reference)
    V = cfg.vocab_size
    w = tm.serving_weights(params, cfg)
    tc = tm.init_caches(cfg, 2, max_len, "cpu")
    for slot, (prompt, jl) in enumerate(zip(prompts, pre)):
        tl, tc = tm.lm_prefill_into(w, cfg, tc, {"tokens": torch.from_numpy(prompt).long()},
                                    slot, max_len, masks=masks, pack=pack)
        _close(tl[..., :V], jl[..., :V], f"prefill {slot}", tol)
    for step, (active, (cur, pos, jl)) in enumerate(zip(actives, steps)):
        frozen = [{n: v[0].clone() for n, v in c["kv"].items()} for c in tc]
        tl, tc = tm.lm_decode(w, cfg, tc, torch.from_numpy(cur)[:, None].long(),
                              torch.from_numpy(pos).long(), masks=masks, pack=pack,
                              active=torch.from_numpy(active))
        _close(tl[active], jl[active], f"decode {step}", tol)
        if not active[0]:
            assert all(torch.equal(c["kv"][n][0], f[n]) for c, f in zip(tc, frozen)
                       for n in f), step


@pytest.mark.parametrize("mode,dtype,tol", [("masked", "float32", TOL),
                                            ("block_sparse", "float32", TOL),
                                            ("block_sparse", "bfloat16", 5e-3)])
def test_prefill_decode_match_reference(mode, dtype, tol):
    """A 20-token prompt wraps the smoke window's 16-slot rings."""
    prefill_decode_match(ARCH, mode, dtype, tol)


def drain(engine):
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


REQ = dict(prompt_lens=(21, 5), gen_lens=(6, 4, 5))


def test_engine_streams_match_reference_contiguous_and_paged():
    """The reference engine against the port's, contiguous and paged, on
    the same weights and masks (block_sparse): equal greedy streams and
    slots.  The paged engine holds a local ring pool and a global pool; a
    21-token prompt plus its tokens wraps the 16-slot rings; every page
    comes back."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    jreqs = j_requests(jcfg, 4, **REQ)
    jeng = JEngine(jcfg, _jx(params), capacity=2, max_len=48, masks=_jx(masks))
    for r in jreqs:
        assert jeng.submit(r)
    drain(jeng)
    for paged in (False, True):
        treqs = t_requests(cfg, 4, **REQ)
        eng = TEngine(cfg, params, capacity=2, max_len=48, masks=masks, pack=pack,
                      paged=paged, page_size=8)
        if paged:
            assert sorted(eng.pools) == ["global", "local"]
        for r in treqs:
            assert eng.submit(r)
        drain(eng)
        assert all(r.status is Status.DONE for r in treqs)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs], paged
        assert eng.slot_history == jeng.slot_history
        if paged:
            eng.check_pool_accounting()
            assert all(p.n_live == 0 for p in eng.pools.values())


def test_prefix_cache_refused_for_gemma3():
    """Local ring layers cannot share pages, as in the reference."""
    _, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    with pytest.raises(ValueError, match="all-global"):
        TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                paged=True, prefix_cache=2)


def clis_run(arch, tmp_path, serve_args):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import train_loop
    stats = serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                        *serve_args])
    assert stats["requests"] == 3 and stats["failed"] == 0
    cfg = configure_kernel(t_get_config(arch, smoke=True), kernel="block_sparse", block=BLOCK)
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, delta_t=2, alpha=0.9))
    state, log = train_loop(cfg, steps=4, batch=2, seq=32, workdir=str(tmp_path),
                            device="cpu", ckpt_every=None, log_every=4)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tpack.validate_pack(state["pack"]) == len(tree_paths(state["masks"]))
    assert int(tpack.pack_mismatch(state["masks"], state["pack"], (BLOCK, BLOCK),
                                   bwd_masks=state["bwd_masks"])) == 0


def test_serve_and_train_clis_run_gemma3(tmp_path):
    clis_run(ARCH, tmp_path, ["--kernel", "masked", "--attn-kernel", "flash_tight",
                              "--paged"])


# --------------------------------------------------------------------------
# the plain flash at head_dim 256
# --------------------------------------------------------------------------

FLASH_256 = {  # (Sq, Sk, causal, window, G): one or two 16-padded blocks a side
    "causal S=64 G=2": (64, 64, True, 0, 2),
    "window 20 S=64 G=2": (64, 64, True, 20, 2),
    "causal S=37 (odd)": (37, 37, True, 0, 1),
    "window 12 S=48 G=4": (48, 48, True, 12, 4),
    "q_offset 27 (Sq 21, Sk 48)": (21, 48, True, 0, 2),
    "non-causal S=32 G=2": (32, 32, False, 0, 2),
}


@pytest.mark.parametrize("name", list(FLASH_256))
def test_plain_flash_d256_matches_reference(name):
    """``flash_attention`` on the CPU (K9's plain version forward, K10 and
    K11's backward) at head_dim 256, bf16, against the reference's
    ``flash_attention`` in interpret mode: o and the gradients of q, k and
    v; and the walked plain version on K10/K11's d = 256 walks (32-key
    tiles for K10) equal to the unwalked one."""
    Sq, Sk, causal, window, G = FLASH_256[name]
    d, BH = 256, 4
    rng = np.random.default_rng(len(name))
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
    q, do = bf(BH, Sq, d), bf(BH, Sq, d)
    k, v = bf(BH // G, Sk, d), bf(BH // G, Sk, d)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jkw = dict(causal=causal, window=window, kv_groups=G)
    jo, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, interpret=True, **jkw),
                      j(q), j(k), j(v))
    want = [jo, *vjp(j(do))]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, **jkw)
    got = [o, *torch.autograd.grad(o, leaves, do)]
    tol = 2.0 ** -6
    for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        ref = np.asarray(jnp.asarray(w, jnp.float32))
        err = float(np.max(np.abs(g.detach().float().numpy() - ref)))
        assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), (what, err)

    bq, bk = tfa.effective_blocks(Sq, Sk)
    Sqp, Skp = -(-Sq // bq) * bq, -(-Sk // bk) * bk
    from repro_torch.core.attn_sched import sched_for
    sched = sched_for(Sq, Sk, bq, bk, causal, window, Sk - Sq)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))
    qp, dop, kp, vp = pad(q, Sqp), pad(do, Sqp), pad(k, Skp), pad(v, Skp)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=Sk - Sq, sk=Sk,
              scale=d ** -0.5, softcap=0.0, kv_groups=G)
    idx = [torch.from_numpy(sched[n]) for n in ("kv_idx", "kv_cnt")]
    o, lse = tfa.flash_attention_plain(qp, kp, vp, *idx, **kw)
    delta = (dop.float() * o.float()).sum(-1)
    walks = [tfa.bwd_walks(kind, sched[a], sched[b], bq=bq, bk=bk, causal=causal,
                           window=window, q_offset=Sk - Sq, sk=Sk, groups=G,
                           unit_rows=tfa.bwd_unit_rows(kind, d), pair=True, n_split=2,
                           tile_rows=tfa.bwd_tile_rows(kind, d))
             for kind, a, b in (("dq", "kv_idx", "kv_cnt"), ("dkv", "q_idx", "q_cnt"))]
    assert all(n <= tfa.bwd_tile_rows("dq", d) for _, units in walks[0]
               for _, _, steps in units for _, _, n in steps)
    walked = tfa.flash_bwd_walked_plain(qp, kp, vp, dop, lse, delta, *walks, n_split_dq=2,
                                        n_split_dkv=2, **kw)
    blocks = tfa._schedule_mask(*idx, Skp // bk, "cpu")
    *plain, rq, rk, rv, eq, ek, ev = tfa.flash_bwd_plain(qp, kp, vp, dop, lse, delta, blocks,
                                                         with_abs=True, **kw)
    for g, w, r, e in zip(walked, plain, (rq, rk, rv), (eq, ek, ev)):
        assert bool(((g.float() - w.float()).abs() <= tfa.grad_error_bound(w, r, e)).all())
