"""Port internvl2-1b (patch prompts) vs the JAX package on the smoke config,
block 16.

Covers the slice bottom up: the config copy; the init layout (the dense
``frontend_proj`` beside the tied ``embed``, no ``head``) and the ERK map;
``vlm_batch``'s shapes; ``lm_loss`` over the text positions and the
gradient of every leaf under masked and block_sparse; a prefill with
patches into two slots, then decode steps (logits against the
reference's, with the decode positions past the patch rows); the engine's
greedy streams, contiguous and paged, against the reference engine's on
the same requests; a request without patches and one whose patch rows
overflow ``max_len`` raising as the reference's; the prefix cache
refused; the CLIs.

The weights are the reference's own init (seed 0) carried by ``bridge``
and the port's 16x16-block ERK masks (``test_torch_gemma3.py``'s
``_state``).  Tolerance: 1e-4 of the largest magnitude compared (f32
sums in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemma3 import (  # noqa: E402
    _close,
    _jx,
    _ref,
    _state,
    config_matches,
    drain,
    init_layout_matches,
    one_thread,  # noqa: F401  (the module fixture)
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.data.synthetic import vlm_batch as j_vlm_batch  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.data.synthetic import batch_for  # noqa: E402
from repro_torch.launch.serve import serve_session  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

ARCH = "internvl2-1b"
REQ = dict(prompt_lens=(5, 9), gen_lens=(6, 4, 5))
MAX_LEN = 32


def test_config_copy_matches_reference():
    config_matches(ARCH)
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size) == (24, 896, 14, 2, 64, 4864, 151655)
    assert (full.frontend, full.frontend_dim, full.n_patches) == ("patch", 1024, 256)
    assert full.tie_embeddings and tm.padded_vocab(full) == 151808


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """Paths, shapes and sparse flags of the reference's tree
    (``init_layout_matches``): the dense ``frontend_proj`` (frontend_dim x
    d_model) beside the tied ``embed``, no ``head``; the same ERK map."""
    shapes, flags = init_layout_matches(ARCH, smoke)
    tcfg = t_get_config(ARCH, smoke=smoke)
    assert "head/w" not in shapes and "embed/table" in shapes
    assert tuple(shapes["frontend_proj/w"].shape) == (tcfg.frontend_dim, tcfg.d_model)
    assert not flags["frontend_proj/w"]


def test_vlm_batch_shapes():
    """``batch_for`` gives a patch config ``vlm_batch``: seq - n_patches
    text tokens on the affine task and (batch, n_patches, frontend_dim)
    f32 patches, the reference's shapes."""
    cfg = t_get_config(ARCH, smoke=True)
    b = batch_for(cfg, 2, 3, 20, learnable=True)
    want = j_vlm_batch(get_config(ARCH, smoke=True), 2, 3, 20)
    assert sorted(b) == sorted(want) == ["patches", "targets", "tokens"]
    for n in b:
        assert tuple(b[n].shape) == tuple(want[n].shape), n
    assert tuple(b["tokens"].shape) == (3, 20 - cfg.n_patches)
    assert torch.equal(b["targets"], (b["tokens"] * 3 + 7) % cfg.vocab_size)
    assert b["patches"].dtype == torch.float32


def _inputs(cfg, seed=5, B=2, T=20):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32))


@pytest.mark.parametrize("mode", ["masked", "block_sparse"])
def test_lm_loss_and_grads_match_reference(mode):
    """The loss over the 20 text positions of 4 patch rows + 20 tokens
    (the reference's ``lm_loss`` scores the last T rows) and the gradient
    of every leaf (``frontend_proj`` and the tied table included) on the
    reference's weights, against the reference on w * m; the kernel
    modes' weight gradients zero outside the mask."""
    jcfg, cfg, params, masks, pack = _state(ARCH, mode)
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                              attn_kernel="flash_tight"))
    toks, tgt, pt = _inputs(cfg)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt), "patches": jnp.asarray(pt)}

    def reference():
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: j_lm_loss(p, jcfg, jb, masks=_jx(masks))))(_jx(params))
        return loss, j_tree_paths(g)

    want, jg = _ref((ARCH, "loss"), reference)
    tb = {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgt).long(),
          "patches": torch.from_numpy(pt)}
    leaves = tree_paths(params)
    tp = tree_map(lambda _, t: t.clone().requires_grad_(True), params)
    loss = tm.lm_loss(tp, cfg, tb, masks=masks, pack=pack)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    tl = tree_paths(tp)
    grads = dict(zip(leaves, torch.autograd.grad(loss, [tl[n] for n in leaves])))
    mflat = tree_paths(masks)
    assert {"frontend_proj/w", "embed/table", "layers/0/attn/wq/w"} <= grads.keys()
    assert float(grads["frontend_proj/w"].abs().max()) > 0.0
    for n, g in grads.items():
        _close(g, jg[n], f"{mode} grad {n}")
        if n in mflat:
            assert float(g[~mflat[n]].abs().max()) == 0.0, n


def test_prefill_with_patches_then_decode_match_reference():
    """Two 7-token prompts, each with its 4 patch rows, admitted into
    shared contiguous caches (block_sparse, f32), then 3 decode steps at
    positions past the patch rows, slot 0 inactive in the last: prefill and
    decode logits against the reference's ``lm_prefill_into`` and
    ``lm_decode`` (greedy tokens fed back)."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    P, L = cfg.n_patches, 7
    toks, _, pt = _inputs(cfg, seed=9, T=L)
    actives = [np.array([step < 2, True]) for step in range(3)]

    def reference():
        jp, jm = _jx(params), _jx(masks)
        jc = j_init_caches(jcfg, 2, MAX_LEN)
        pre = []
        fill = jax.jit(lambda c, t, x, s_: j_lm_prefill_into(
            jp, jcfg, c, {"tokens": t, "patches": x}, s_, MAX_LEN, masks=jm))
        for slot in range(2):
            jl, jc = fill(jc, jnp.asarray(toks[slot:slot + 1]), jnp.asarray(pt[slot:slot + 1]),
                          slot)
            pre.append(np.asarray(jl))
        j_dec = jax.jit(lambda c, t, pos, act: j_lm_decode(
            jp, jcfg, c, t, pos, masks=jm, active=act))
        cur = np.array([int(np.argmax(jl[0, -1])) for jl in pre])
        pos = np.full(2, L + P, np.int32)
        steps = []
        for active in actives:
            jl, jc = j_dec(jc, jnp.asarray(cur)[:, None], jnp.asarray(pos), jnp.asarray(active))
            steps.append((cur, pos.copy(), np.asarray(jl)))
            cur = np.where(active, np.argmax(np.asarray(jl)[:, -1], -1), cur)
            pos = pos + active
        return pre, steps

    pre, steps = _ref((ARCH, "serve"), reference)
    V = cfg.vocab_size
    w = tm.serving_weights(params, cfg)
    assert w["frontend_proj"]["w"].dtype == torch.float32  # the f32 config's dtype
    tc = tm.init_caches(cfg, 2, MAX_LEN, "cpu")
    for slot, jl in enumerate(pre):
        batch = {"tokens": torch.from_numpy(toks[slot:slot + 1]).long(),
                 "patches": torch.from_numpy(pt[slot:slot + 1])}
        tl, tc = tm.lm_prefill_into(w, cfg, tc, batch, slot, MAX_LEN, masks=masks, pack=pack)
        _close(tl[..., :V], jl[..., :V], f"prefill {slot}")
    for step, (active, (cur, pos, jl)) in enumerate(zip(actives, steps)):
        tl, tc = tm.lm_decode(w, cfg, tc, torch.from_numpy(cur)[:, None].long(),
                              torch.from_numpy(pos).long(), masks=masks, pack=pack,
                              active=torch.from_numpy(active))
        _close(tl[active], jl[active], f"decode {step}")


def test_engine_streams_match_reference_contiguous_and_paged():
    """The reference engine against the port's, contiguous and paged, on
    the same weights and masks (block_sparse) and the same requests (each
    package's ``staggered_requests``: the same patches and tokens): equal
    greedy streams and slots; the paged engine's books clean."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    jreqs = j_requests(jcfg, 4, **REQ)
    jeng = JEngine(jcfg, _jx(params), capacity=2, max_len=MAX_LEN, masks=_jx(masks))
    for r in jreqs:
        assert jeng.submit(r)
    drain(jeng)
    for paged in (False, True):
        treqs = t_requests(cfg, 4, **REQ)
        for a, b in zip(jreqs, treqs):
            np.testing.assert_array_equal(a.patches, b.patches)
            np.testing.assert_array_equal(a.tokens, b.tokens)
        eng = TEngine(cfg, params, capacity=2, max_len=MAX_LEN, masks=masks, pack=pack,
                      paged=paged, page_size=8)
        for r in treqs:
            assert eng.submit(r)
        drain(eng)
        assert all(r.status is Status.DONE for r in treqs)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs], paged
        assert eng.slot_history == jeng.slot_history
        if paged:
            eng.check_pool_accounting()
            assert all(p.n_live == 0 for p in eng.pools.values())


def test_engine_refuses_as_the_reference():
    """A patch config's request without patches, and one whose prompt +
    tokens fit ``max_len`` only without the patch rows, raise ValueError in
    both engines; the prefix cache is refused for a frontend config."""
    jcfg, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    jeng = JEngine(jcfg, _jx(params), capacity=1, max_len=MAX_LEN, masks=_jx(masks))
    teng = TEngine(cfg, params, capacity=1, max_len=MAX_LEN, masks=masks, pack=pack)
    for make, eng in ((j_requests, jeng), (t_requests, teng)):
        bare = make(cfg, 1, prompt_lens=(5,), gen_lens=(4,))[0]
        bare.patches = None
        with pytest.raises(ValueError, match="patches"):
            eng.submit(bare)
        long = make(cfg, 1, prompt_lens=(20,), gen_lens=(10,))[0]  # 20 + 4 + 10 > 32
        with pytest.raises(ValueError, match="patches"):
            eng.submit(long)
        fits = make(cfg, 1, prompt_lens=(18,), gen_lens=(10,))[0]  # 18 + 4 + 10 = 32
        assert eng.submit(fits)
    with pytest.raises(ValueError, match="frontend"):
        TEngine(cfg, params, capacity=2, max_len=MAX_LEN, masks=masks, pack=pack,
                paged=True, page_size=8, prefix_cache=2)


def test_serve_and_train_clis_run_internvl(tmp_path):
    """The serve CLI (paged, masked) and ``serve_session`` (decode
    positions past the patch rows: its first decode step's logits equal a
    prefill's over the prompt and its first token) and the train CLI on
    the smoke config (patch batches through ``batch_for``)."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    stats = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                        "--kernel", "masked", "--attn-kernel", "flash_tight", "--paged"])
    assert stats["requests"] == 3 and stats["failed"] == 0
    _, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    toks, _, pt = _inputs(cfg, seed=3, B=2, T=6)
    prompt, patches = torch.from_numpy(toks).long(), torch.from_numpy(pt)
    out, _ = serve_session(cfg, params, batch=2, prompt_len=6, gen=2, masks=masks, pack=pack,
                           prompt=prompt, patches=patches)
    w = tm.serving_weights(params, cfg)
    longer = {"tokens": torch.cat([prompt, out[:, :1]], 1), "patches": patches}
    logits, _ = tm.lm_prefill(w, cfg, longer, 16, masks=masks, pack=pack)
    assert torch.equal(logits[:, -1].argmax(-1), out[:, 1])
    state, log = train_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                             "--batch", "2", "--seq", "24", "--delta-t", "2", "--alpha", "0.9",
                             "--kernel", "block_sparse", "--block", "16",
                             "--workdir", str(tmp_path)])
    assert all(np.isfinite(m["loss"]) for m in log)
    assert "frontend_proj" in state["params"] and "head" not in state["params"]
