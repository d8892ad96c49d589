"""Port hubert-xlarge (the frames encoder) vs the JAX package on the smoke
config, block 16.

Covers the slice bottom up: the config copy; the init layout (the dense
``frontend_proj`` and an untied ``head``, no ``embed``) and the ERK map;
the plain GELU MLP against the reference's ``mlp`` (tanh gelu);
``frames_batch``'s shapes and target rule; ``lm_forward``, ``lm_loss`` and
the gradient of every leaf under dense (the dense attention), masked and
block_sparse (the flash path's plain versions) at a sequence length of
40, which the 16-padded flash blocks do not divide; the bidirectional
flash wrapper and its backward at a padded length against the
reference's kernel in interpret mode, and the walked plain version on
K10/K11's non-causal walks; prefill, decode, the engine and
``serve_session`` refusing the encoder; the train CLI.

The weights are the reference's own init (seed 0) carried by ``bridge``
and the port's 16x16-block ERK masks (``test_torch_gemma3.py``'s
``_state``).  Tolerances, relative to the largest magnitude compared:
1e-4 for f32 results (sums in another order); the bf16 flash case 2**-6
(p and ds rounded to bf16 at the same points, summed in another order),
as ``test_torch_gemma3.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemma3 import (  # noqa: E402
    MODES,
    _close,
    _jx,
    _ref,
    _state,
    config_matches,
    init_layout_matches,
    one_thread,  # noqa: F401  (the module fixture)
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.data.synthetic import frames_batch as j_frames_batch  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import lm_forward as j_lm_forward  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import mlp as jM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.attn_sched import sched_for  # noqa: E402
from repro_torch.core.masks import tree_map, tree_paths  # noqa: E402
from repro_torch.data.synthetic import batch_for, frames_batch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import serve_session  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402

ARCH = "hubert-xlarge"
SEQ = 40  # the flash blocks clamp to 48 rows: 8 padded query and key rows


def test_config_copy_matches_reference():
    config_matches(ARCH)
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size) == (48, 1280, 16, 16, 80, 5120, 504)
    assert (full.frontend, full.frontend_dim, full.mlp_kind, full.causal) == (
        "frames", 512, "gelu", False)
    assert tm.padded_vocab(full) == 512 and not full.tie_embeddings


@pytest.mark.parametrize("smoke", [True, False])
def test_init_layout_and_erk_match_reference(smoke):
    """Paths, shapes and sparse flags of the reference's tree
    (``init_layout_matches``): the dense ``frontend_proj`` (frontend_dim x
    d_model) and ``head``, no ``embed``, the GELU MLP's ``wi`` and ``wo``
    only; the same ERK map."""
    shapes, flags = init_layout_matches(ARCH, smoke)
    tcfg = t_get_config(ARCH, smoke=smoke)
    assert "embed/table" not in shapes and "layers/0/mlp/wg/w" not in shapes
    assert tuple(shapes["frontend_proj/w"].shape) == (tcfg.frontend_dim, tcfg.d_model)
    assert not flags["frontend_proj/w"] and not flags["head/w"]


def test_gelu_mlp_matches_reference():
    """The plain GELU MLP (tanh gelu) on dense weights drawn with numpy and
    under the masked kernel mode on layer 1's masks (the reference's dense
    ``mlp`` on w * m), f32; ReLU on the same weights."""
    _, cfg, _, masks, _ = _state(ARCH, "masked")
    rng = np.random.default_rng(2)
    d, f = cfg.d_model, cfg.d_ff
    p = {n: {"w": torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32))}
         for n, s in (("wi", (d, f)), ("wo", (f, d)))}
    m = masks["layers"][1]["mlp"]
    x = torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
    jx = jnp.asarray(x.numpy())
    with torch.no_grad():
        got = {kind: M.mlp(p, x, kind) for kind in ("gelu", "relu")}
        got_m = M.mlp(p, x, "gelu", masks=m, kernel="masked")
    for kind, g in got.items():
        _close(g, jM.mlp(_jx(p), jx, kind), kind)
    pm = {n: {"w": p[n]["w"] * m[n]["w"]} for n in p}
    _close(got_m, jM.mlp(_jx(pm), jx, "gelu"), "gelu masked")
    assert sorted(M.mlp_init(torch.Generator(), d, f, "gelu")) == ["wi", "wo"]


def test_frames_batch_shapes_and_target_rule():
    """``batch_for`` gives a frames config ``frames_batch``: the reference's
    shapes, and targets = (sum(frames**2) * 7) truncated, mod the vocab,
    as the reference's rule computes them on the same frames (a frame
    whose 7 * energy lies within 1e-3 of an integer may round across it in
    another summation order)."""
    cfg = t_get_config(ARCH, smoke=True)
    b = batch_for(cfg, 3, 2, SEQ, learnable=True)
    want = j_frames_batch(get_config(ARCH, smoke=True), 3, 2, SEQ)
    assert sorted(b) == sorted(want) == ["frames", "targets"]
    for n in b:
        assert tuple(b[n].shape) == tuple(want[n].shape), n
    assert b["frames"].dtype == torch.float32
    fr = jnp.asarray(b["frames"].numpy())
    rule = np.asarray((jnp.sum(fr ** 2, -1) * 7).astype(jnp.int32) % cfg.vocab_size)
    e7 = 7.0 * (b["frames"].double() ** 2).sum(-1).numpy()
    edge = np.abs(e7 - np.round(e7)) < 1e-3
    assert np.array_equal(b["targets"].numpy()[~edge], rule[~edge])
    assert torch.equal(frames_batch(cfg, 3, 2, SEQ)["targets"], b["targets"])
    assert not torch.equal(frames_batch(cfg, 4, 2, SEQ)["frames"], b["frames"])


def _frames(cfg, seed=5, B=2, S=SEQ):
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    return fr, ((fr.astype(np.float64) ** 2).sum(-1) * 7).astype(np.int32) % cfg.vocab_size


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_forward_and_grads_match_reference(mode):
    """``lm_forward``'s hidden states (dense), the loss and the gradient of
    every leaf (``frontend_proj`` and ``head`` included) on the reference's
    weights, 40 frames: the dense mode on the dense attention (the
    reference's ``_make_mask`` path, no mask), the kernel modes on the
    flash path (the plain K9-K11 with 8 padded query and key rows); the
    kernel modes' weight gradients zero outside the mask."""
    jcfg, cfg, params, masks, pack = _state(ARCH, mode)
    if mode != "dense":
        cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(
            cfg.sparse, attn_kernel="flash_tight"))
    fr, tgt = _frames(cfg)
    jm = None if mode == "dense" else _jx(masks)
    jb = {"frames": jnp.asarray(fr), "targets": jnp.asarray(tgt)}

    def reference():
        def f(p):
            hid = j_lm_forward(p, jcfg, jb)[0] if jm is None else None
            return j_lm_loss(p, jcfg, jb, masks=jm), hid

        (loss, hid), g = jax.jit(jax.value_and_grad(f, has_aux=True))(_jx(params))
        return hid, loss, j_tree_paths(g)

    jh, want, jg = _ref((ARCH, "loss", mode == "dense"), reference)
    tb = {"frames": torch.from_numpy(fr), "targets": torch.from_numpy(tgt).long()}
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
    assert {"frontend_proj/w", "head/w", "layers/1/mlp/wi/w"} <= grads.keys()
    for n, g in grads.items():
        _close(g, jg[n], f"{mode} grad {n}")
        if n in mflat and mode != "dense":
            assert float(g[~mflat[n]].abs().max()) == 0.0, n


def test_bidirectional_flash_at_padded_length_matches_reference():
    """``flash_attention`` with ``causal=False`` on the CPU (K9's plain
    version, K10 and K11's backward) at S = 40 (48-row blocks: 8 padded
    query rows and 8 padded keys, masked), head_dim 80, G = 2, bf16,
    against the reference's ``flash_attention`` in interpret mode: o and
    the gradients of q, k and v.  The padded query rows get zero dO from
    the trim, so dk and dv take nothing from them; the walked plain
    version on K10/K11's non-causal walks (every walk the same length,
    each split over 2) equals the unwalked one."""
    S, d, BH, G = SEQ, 80, 4, 2
    rng = np.random.default_rng(11)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
    q, do = bf(BH, S, d), bf(BH, S, d)
    k, v = bf(BH // G, S, d), bf(BH // G, S, d)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jkw = dict(causal=False, window=0, kv_groups=G)
    jo, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, interpret=True, **jkw),
                      j(q), j(k), j(v))
    want = [jo, *vjp(j(do))]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, **jkw)
    got = [o, *torch.autograd.grad(o, leaves, do)]
    for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        ref = np.asarray(jnp.asarray(w, jnp.float32))
        err = float(np.max(np.abs(g.detach().float().numpy() - ref)))
        assert err <= 2.0 ** -6 * max(1.0, float(np.max(np.abs(ref)))), (what, err)

    bq, bk = tfa.effective_blocks(S, S)
    Sp = -(-S // bq) * bq
    assert (bq, Sp) == (48, 48)
    sched = sched_for(S, S, bq, bk, False, 0, 0)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, Sp - S))
    qp, kp, vp = pad(q), pad(k), pad(v)
    dop = pad(do)  # the trim's zero dO on the padded rows
    kw = dict(bq=bq, bk=bk, causal=False, window=0, q_offset=0, sk=S, scale=d ** -0.5,
              softcap=0.0, kv_groups=G)
    idx = [torch.from_numpy(sched[n]) for n in ("kv_idx", "kv_cnt")]
    o, lse = tfa.flash_attention_plain(qp, kp, vp, *idx, **kw)
    delta = (dop.float() * o.float()).sum(-1)
    walks = [tfa.bwd_walks(kind, sched[a], sched[b], bq=bq, bk=bk, causal=False, window=0,
                           q_offset=0, sk=S, groups=G, unit_rows=tfa.bwd_unit_rows(kind, d),
                           pair=True, n_split=2, tile_rows=tfa.bwd_tile_rows(kind, d))
             for kind, a, b in (("dq", "kv_idx", "kv_cnt"), ("dkv", "q_idx", "q_cnt"))]
    # no tile of a padded key is walked: the last live key tile stops at sk
    assert all(k0 < S for _, units in walks[0] for _, _, steps in units
               for _, k0, _ in steps)
    walked = tfa.flash_bwd_walked_plain(qp, kp, vp, dop, lse, delta, *walks, n_split_dq=2,
                                        n_split_dkv=2, **kw)
    blocks = tfa._schedule_mask(*idx, Sp // bk, "cpu")
    *plain, rq, rk, rv, eq, ek, ev = tfa.flash_bwd_plain(qp, kp, vp, dop, lse, delta, blocks,
                                                         with_abs=True, **kw)
    for g, w, r, e in zip(walked, plain, (rq, rk, rv), (eq, ek, ev)):
        assert bool(((g.float() - w.float()).abs() <= tfa.grad_error_bound(w, r, e)).all())
    # the padded keys take no gradient, and the padded query rows none
    assert float(plain[1][:, S:].abs().max()) == 0.0 and float(plain[2][:, S:].abs().max()) == 0.0
    assert float(plain[0][:, S:].abs().max()) == 0.0


def test_encoder_has_no_prefill_decode_or_engine():
    """The reference's prefill asserts a causal config and its engine
    refuses encoders; the port raises ValueError at each entry point."""
    _, cfg, params, masks, pack = _state(ARCH, "block_sparse")
    fr, _ = _frames(cfg, B=1, S=8)
    for call in (
            lambda: tm.lm_prefill(params, cfg, {"frames": torch.from_numpy(fr)}, 16),
            lambda: tm.lm_decode(params, cfg, [], torch.zeros(1, 1, dtype=torch.long), 0),
            lambda: TEngine(cfg, params, capacity=1, max_len=16, masks=masks, pack=pack),
            lambda: serve_session(cfg, params, batch=1, prompt_len=4, gen=2)):
        with pytest.raises(ValueError, match="encoder|causal"):
            call()


def test_train_cli_runs_hubert(tmp_path):
    """The train CLI on the smoke config (frames batches through
    ``batch_for``), block_sparse, a drop/grow at step 2: finite losses."""
    from repro_torch.launch.train import main
    state, log = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                       "--batch", "2", "--seq", "24", "--delta-t", "2", "--alpha", "0.9",
                       "--kernel", "block_sparse", "--block", "16",
                       "--workdir", str(tmp_path)])
    assert len(log) >= 1 and all(np.isfinite(m["loss"]) for m in log)
    assert "embed" not in state["params"] and "frontend_proj" in state["params"]
