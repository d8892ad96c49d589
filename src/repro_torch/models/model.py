"""The LM of the port: init, loss, prefill and decode.

Port of the JAX package's ``models/model.py`` for training and serving the
transformer family (h2o-danube-1.8b, mistral-large-123b), its MoE family
(qwen2-moe-a2.7b: ``models/moe.py`` in place of the MLP, its expert banks
through ``layers.grouped_linear``), the xLSTM family (xlstm-1.3b:
``models/xlstm.py``, mLSTM and sLSTM blocks with recurrent per-slot states
in place of KV caches; tied embeddings) and the hybrid family (hymba-1.5b:
``models/ssm.py``'s selective SSM beside the attention in every block,
each normed and the two averaged; a KV cache and an SSM state per slot),
parallel blocks (command-r-plus-104b: the attention and the FFN read the
same normed input and join the residual together), gemma3 (gemma3-4b:
qk-norm, sandwich norms on both outputs, GeGLU, 5:1 local:global) and the
two frontend stubs: an encoder on frames (hubert-xlarge: precomputed frame
embeddings through the dense ``frontend_proj`` in place of a token
embedding, bidirectional attention, a plain GELU MLP, its own head; no
prefill or decode) and a VLM (internvl2-1b: a prompt's patch embeddings
through ``frontend_proj``, put in front of its text's token embeddings;
the loss scores the text positions only).
Every weight matmul goes
through ``layers.linear`` or ``grouped_linear`` (the block-sparse kernels
under ``cfg.sparse.kernel='block_sparse'``, the masked kernels under
``kernel='masked'``, forward and backward), full-sequence
attention through the flash kernels, decode attention and the LM head are
plain PyTorch.  A tied head (no ``head`` leaf) is ``h @ table.T`` in h's
dtype, as the reference.  ``lm_loss`` is differentiable; with ``cfg.remat`` each
group of ``cfg.remat_group`` blocks is a ``torch.utils.checkpoint`` region
(the reference's ``jax.checkpoint``; under ``remat_policy='dots'`` a
selective one that also saves the dense products' outputs): it changes
memory, not numbers.

Dtypes follow the reference's actual flow: the embedding is gathered in the
compute dtype and scaled by sqrt(d_model) into an f32 residual stream
(NumPy's float64 scalar promotes it there in the reference; a VLM's patch
rows, projected in the compute dtype, join it promoted to f32), while a
frames config's residual is ``frontend_proj``'s output in the compute
dtype (no scale: under a bf16 config the whole encoder, its MLP and head
included, runs in bf16, as in the reference), rmsnorm keeps
the residual's dtype, the attention projections cast to ``cfg.dtype`` (and
``wo`` inherits the attention output's dtype), while the MLP and the LM head
inherit the residual's f32.  Under a bf16 config the MLP's (and the MoE's
banks, router and shared MLP) block-sparse or masked matmuls therefore run
in f32, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..kernels.opaque import inside_kernel
from . import attention as A
from . import ssm as S
from . import xlstm as X
from .layers import (
    P,
    compute_dtype,
    linear,
    linear_init,
    rmsnorm,
    rmsnorm_init,
    split_params,
)
from .mlp import mlp, mlp_init
from .moe import moe, moe_init

__all__ = [
    "padded_vocab",
    "init_lm",
    "lm_axes",
    "serving_weights",
    "lm_forward",
    "lm_loss",
    "init_caches",
    "cache_group",
    "init_paged_caches",
    "lm_prefill",
    "lm_prefill_into",
    "lm_prefill_suffix",
    "lm_decode",
    "logits_all_finite",
]


def padded_vocab(cfg) -> int:
    """Vocab padded to a multiple of 256; pad logits are masked in _logits."""
    return ((cfg.vocab_size + 255) // 256) * 256


def _check_ported(cfg) -> None:
    if cfg.block_type not in ("transformer", "xlstm", "hymba"):
        raise NotImplementedError(
            f"config {cfg.name!r}: block_type {cfg.block_type!r} not ported yet "
            "(the port runs the transformer family, xLSTM and hymba)")


def _check_decodes(cfg, what: str) -> None:
    """Prefill and decode exist for causal models only, as in the
    reference (an encoder has no decode step)."""
    if not cfg.causal:
        raise ValueError(f"{what}: prefill/decode undefined for encoder-only models "
                         f"(config {cfg.name!r})")


def init_lm(cfg, seed: int = 0, *, device=None):
    """Random weights from ``seed`` -> (params, sparse_flags) trees, f32
    (or, under ``param_dtype='bfloat16'``, bf16) masters on ``device``
    (default ``cuda``).  Layout as the reference's
    ``init_lm``; the draws are torch's, not ``jax.random``'s.  An MoE
    config's layers hold ``moe`` (``models/moe.py``) in place of ``mlp``;
    an xLSTM config's hold ``ln1`` and an ``mlstm`` or (every
    ``cfg.slstm_every``-th) an ``slstm`` block; a hymba config's hold
    ``ssm``, ``attn_norm`` and ``ssm_norm`` beside the attention.  A
    ``parallel_block`` layer has no ``ln2``; ``post_norms`` adds
    ``ln1_post`` and ``ln2_post``.  Tied embeddings: no ``head`` leaf.  A
    frontend config holds the dense ``frontend_proj`` (frontend_dim ->
    d_model); a ``frames`` config has no ``embed`` and always a ``head``,
    a ``patch`` config both ``frontend_proj`` and ``embed``.

    Under ``param_dtype='bfloat16'`` (grok-1-314b) every f32 leaf is cast
    to bf16 as its layer (or the embedding, or the head) is drawn: the
    same bits as the reference's cast of the whole f32 tree after
    ``init_lm`` (``init_train_state``), without the whole tree ever
    existing in f32 (four full-width grok layers are 79 GB in f32).

    The reference's ``init_lm`` returns a third tree, the logical axes;
    here ``lm_axes`` gives it."""
    _check_ported(cfg)
    dev = resolve_device(device)
    params, _, flags = split_params(_lm_tree(cfg, torch.Generator(device=dev).manual_seed(seed)))
    return params, flags


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the inits draw
    through ``generator=gen, device=gen.device``, and torch draws on the
    meta device from a CPU generator (it has no generator of its own)."""

    @property
    def device(self):
        return torch.device("meta")


def lm_axes(cfg):
    """The logical-axes tree of ``init_lm(cfg)`` (the reference's second
    return value): a tuple of axis names (or None) per dim of every leaf.

    ``init_lm`` keeps its two trees, which every caller of the port takes;
    the axes come from a separate init on the ``meta`` device instead.  It
    draws nothing and allocates nothing (grok-1-314b's tree costs no
    memory), and the axes are a function of the config alone, as the
    resolver (``launch/sharding.py``) needs them."""
    _check_ported(cfg)
    return split_params(_lm_tree(cfg, _MetaGenerator()))[1]


def _lm_tree(cfg, gen):
    """``init_lm``'s tree of ``P`` bundles, drawn from ``gen`` on
    ``gen.device``."""
    dev = gen.device
    d, pv = cfg.d_model, padded_vocab(cfg)
    masters = _masters(cfg)

    def ff():
        if cfg.n_experts:
            return {"moe": moe_init(gen, cfg)}
        return {"mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind)}

    def layer(i):
        if cfg.block_type == "xlstm":
            if cfg.is_slstm(i):
                return {"ln1": rmsnorm_init(d, dev), "slstm": X.slstm_init(gen, cfg)}
            return {"ln1": rmsnorm_init(d, dev), "mlstm": X.mlstm_init(gen, cfg)}
        mixer = {"ln1": rmsnorm_init(d, dev), "attn": A.attn_init(gen, cfg)}
        if cfg.block_type == "hymba":
            mixer.update(ssm=S.ssm_init(gen, cfg), attn_norm=rmsnorm_init(d, dev),
                         ssm_norm=rmsnorm_init(d, dev))
        if not cfg.parallel_block:
            mixer["ln2"] = rmsnorm_init(d, dev)
        if cfg.post_norms:
            mixer.update(ln1_post=rmsnorm_init(d, dev), ln2_post=rmsnorm_init(d, dev))
        return {**mixer, **ff()}

    tree = {}
    if cfg.frontend != "none":
        tree["frontend_proj"] = masters(linear_init(gen, cfg.frontend_dim, d,
                                                    ("frontend", "embed"), sparse=False))
    if cfg.frontend != "frames":
        tree["embed"] = masters({"table": P(
            0.02 * torch.randn(pv, d, generator=gen, device=dev), ("vocab", "embed"))})
    tree["layers"] = [masters(layer(i)) for i in range(cfg.n_layers)]
    tree["ln_f"] = masters(rmsnorm_init(d, dev))
    if not cfg.tie_embeddings or cfg.frontend == "frames":
        tree["head"] = masters(linear_init(gen, d, pv, ("embed", "vocab"), sparse=False))
    return tree


def _masters(cfg):
    """The cast of a freshly drawn subtree of ``P`` bundles to the master
    dtype: every f32 leaf to bf16 under ``param_dtype='bfloat16'`` (the
    reference's ``init_train_state`` cast), else the identity."""
    if cfg.param_dtype != "bfloat16":
        return lambda t: t

    def cast(t):
        if isinstance(t, P):
            if t.value.dtype == torch.float32:
                t.value = t.value.to(torch.bfloat16)
            return t
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return [cast(v) for v in t]

    return cast


def serving_weights(params, cfg):
    """The params with the embedding table, the attention weights and
    ``frontend_proj`` cast to the compute dtype, ONCE.  The reference casts
    the f32 masters inside every call (``layers.linear``, the embedding
    gather); casting once gives the same bits without re-reading f32
    weights on every decode step.  The
    MLP weights (an MoE's banks, router and shared MLP too), the xLSTM
    blocks, hymba's SSM, norm scales (qk-norm's ``q_norm``/``k_norm``
    under ``attn`` included: rmsnorm reads them in f32) and the LM head
    stay f32: the reference computes them in the f32 residual's dtype.  A
    tied table stays f32 too: the head reads it in h's dtype (the gather
    casts its rows).  Under bf16 masters (grok-1-314b) the leaves already
    in the compute dtype come through as they are (``.to`` copies
    nothing), and the expert banks and the head stay bf16: the kernels'
    Functions (and ``layers.linear``'s dense product) upcast them to the
    f32 residual's dtype per call, so no f32 copy of a 6.4 GB bank stays
    resident."""
    dt = compute_dtype(cfg)
    out = dict(params)
    if "head" in params and "embed" in params:
        out["embed"] = {"table": params["embed"]["table"].to(dt)}
    if "frontend_proj" in params:
        out["frontend_proj"] = {"w": params["frontend_proj"]["w"].to(dt)}
    out["layers"] = [
        dict(lp, attn={name: {"w": leaf["w"].to(dt)} if "w" in leaf else leaf
                       for name, leaf in lp["attn"].items()})
        if "attn" in lp else lp
        for lp in params["layers"]
    ]
    return out


def _sub(tree, key):
    return None if tree is None else tree[key]


def _per_layer(tree, cfg):
    return tree["layers"] if tree is not None else [None] * cfg.n_layers


def _state_key(cfg, i: int) -> str:
    """The block of an xLSTM config's layer i, and its cache's key."""
    return "slstm" if cfg.is_slstm(i) else "mlstm"


def _embed(params, cfg, batch):
    """The reference's ``_embed_inputs``: frames through ``frontend_proj``
    in the compute dtype; else the scaled token embedding, a ``patch``
    config's projected patches in front of it when the batch carries them
    (decode steps do not: the prompt's patch K/V lie in the cache)."""
    dt = compute_dtype(cfg)
    if cfg.frontend == "frames":
        return linear(params["frontend_proj"], batch["frames"].to(dt))
    table, tokens = params["embed"]["table"], batch["tokens"]
    if table.requires_grad and torch.is_grad_enabled():
        # the reference's cast-then-gather: its gradient is a scatter-add
        # in the compute dtype
        x = table.to(dt)[tokens]
    else:  # the same bits without casting the whole table (a tied f32 one)
        x = table[tokens].to(dt)
    x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    if cfg.frontend == "patch" and "patches" in batch:
        pe = linear(params["frontend_proj"], batch["patches"].to(dt))
        x = torch.cat([pe.float(), x], dim=1)
    return x


def _seq_len(cfg, batch) -> int:
    """Rows ``_embed`` gives a batch: its tokens, and its patches in front
    under a ``patch`` config."""
    n = batch["tokens"].shape[1]
    if cfg.frontend == "patch" and "patches" in batch:
        n += batch["patches"].shape[1]
    return n


def _ff(p, x, cfg, masks, pack, active=None):
    """The block's feed-forward: ``moe`` for an MoE config (-> (out, aux)),
    else the MLP (aux 0.0).  ``active`` reaches the MoE's routing."""
    if cfg.n_experts:
        return moe(p["moe"], x, cfg, masks=_sub(masks, "moe"),
                   pack=_sub(pack, "moe"), active=active)
    return mlp(p["mlp"], x, cfg.mlp_kind, masks=_sub(masks, "mlp"),
               kernel=cfg.sparse.kernel, block=cfg.sparse.kernel_block,
               pack=_sub(pack, "mlp")), 0.0


def _join(p, x, h, attn_out, cfg, masks, pack, active=None):
    """The block after its mixer -> (x, aux), as the reference: the
    attention output post-normed under ``post_norms``; the FFN reads
    ``h`` (the mixer's input) under ``parallel_block`` and joins the
    residual beside the attention (x + attn_out + ff_out), else reads
    rmsnorm(ln2) of x + attn_out; its output post-normed too."""
    if cfg.post_norms:
        attn_out = rmsnorm(p["ln1_post"], attn_out, cfg.norm_eps)
    if cfg.parallel_block:
        ff_in = h
    else:
        x = x + attn_out
        ff_in = rmsnorm(p["ln2"], x, cfg.norm_eps)
    ff_out, aux = _ff(p, ff_in, cfg, masks, pack, active)
    if cfg.post_norms and cfg.d_ff:
        ff_out = rmsnorm(p["ln2_post"], ff_out, cfg.norm_eps)
    if cfg.parallel_block:
        return x + attn_out + ff_out, aux
    return x + ff_out, aux


def _hymba_mix(p, attn_out, ssm_out, cfg):
    """Hymba's two heads, each normed, averaged (bf16 attention plus the
    f32 SSM promotes to f32, as in the reference)."""
    return 0.5 * (rmsnorm(p["attn_norm"], attn_out, cfg.norm_eps)
                  + rmsnorm(p["ssm_norm"], ssm_out, cfg.norm_eps))


def _block(p, x, cfg, i, *, positions=None, masks=None, pack=None,
           history=None):
    """Full-sequence block (prefill).  Returns (x, state, aux): the state is
    (k, v), an xLSTM block's final recurrent state, or a hymba block's
    ((k, v), the SSM's final h, its pre-conv inputs u); aux is the MoE's
    load-balancing loss (0.0 without experts).  ``history``: this layer's
    paged-prefix dict for a suffix prefill (``attention(history=)``)."""
    if cfg.block_type == "xlstm":
        key = _state_key(cfg, i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        kw = dict(masks=_sub(masks, key), pack=_sub(pack, key))
        o, state = (X.slstm(p[key], h, cfg, **kw) if key == "slstm" else
                    X.mlstm(p[key], h, cfg, chunk=cfg.q_chunk, **kw))
        return x + o, state, 0.0
    kind = cfg.layer_kind(i)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = A.attention(
        p["attn"], h, cfg, kind=kind, positions=positions,
        masks=_sub(masks, "attn"), pack=_sub(pack, "attn"), history=history,
    )
    state = kv
    if cfg.block_type == "hymba":
        # the same h feeds both heads
        ssm_out, ssm_h, u = S.ssm(p["ssm"], h, cfg, chunk=cfg.q_chunk,
                                  masks=_sub(masks, "ssm"), pack=_sub(pack, "ssm"),
                                  with_u=True)
        attn_out = _hymba_mix(p, attn_out, ssm_out, cfg)
        state = (kv, ssm_h, u)
    x, aux = _join(p, x, h, attn_out, cfg, masks, pack)
    return x, state, aux


def _logits(params, cfg, h):
    if "head" in params:
        out = linear(params["head"], h, h.dtype).float()
    else:  # tied: the table in h's dtype
        out = (h @ params["embed"]["table"].to(h.dtype).T).float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        out = c * torch.tanh(out / c)
    pad = out.shape[-1] - cfg.vocab_size
    if pad:  # mask vocab-padding slots (out of place: autograd may need out)
        out = torch.cat([out[..., :cfg.vocab_size],
                         out.new_full((*out.shape[:-1], pad), -1e30)], dim=-1)
    return out


_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm)


def dots_policy(ctx, op, *args, **kwargs):
    """The selective checkpoint policy of ``remat_policy='dots'``, the
    reference's ``checkpoint_dots``: save the output of every dense product
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``: what ``dot_general`` lowers to
    here) and recompute everything else.  A kernel's Function is opaque
    (``kernels/opaque.py``), as a ``pallas_call`` is to the reference's
    policy: the products its plain version runs are recomputed too."""
    if op.overloadpacket in _DOTS and not inside_kernel():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_contexts():
    """The forward and recompute contexts of one 'dots' region."""
    return create_selective_checkpoint_contexts(dots_policy)


def _remat_kw(cfg) -> dict:
    """``checkpoint``'s extra arguments for ``cfg.remat_policy`` (any
    value but 'dots' saves the region's input alone, as in the
    reference)."""
    return {"context_fn": dots_contexts} if cfg.remat_policy == "dots" else {}


def lm_forward(params, cfg, batch, *, masks=None, pack=None, positions=None,
               collect_states: bool = True, histories=None):
    """Full-sequence forward -> (hidden (B, S, d), per-layer states, aux):
    a state is ``_block``'s (k, v), xLSTM or hymba state; aux sums
    the MoE layers' load-balancing losses (0.0 without experts).

    Without ``collect_states`` (the loss) and with ``cfg.remat`` under
    autograd, each group of ``cfg.remat_group`` blocks runs as one
    checkpoint region: under ``remat_policy='none'`` only its input is
    saved and its forward reruns in the backward (so the forward kernels
    launch twice per step); under ``'dots'`` the region also saves the
    outputs of its dense products (``dots_policy``), and the kernels still
    rerun.  Both policies give the same gradients: only what is saved
    changes.  The states list is then empty, as in the reference.

    ``positions``: absolute RoPE positions ((S,) or (B, S)), default
    arange(S).  ``histories``: per-layer paged-prefix dicts for a suffix
    prefill (``lm_prefill_suffix``); ``batch`` is then the suffix and
    ``positions`` carry its offsets."""
    _check_ported(cfg)
    if histories is not None and not collect_states:
        raise ValueError("lm_forward: histories (suffix prefill) collect states")
    x = _embed(params, cfg, batch)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    layers = list(zip(params["layers"], _per_layer(masks, cfg), _per_layer(pack, cfg)))
    states = []
    aux = 0.0
    if cfg.remat and not collect_states and torch.is_grad_enabled():
        g = max(cfg.remat_group, 1)
        kw = _remat_kw(cfg)

        def region(i0, x_):
            aux_ = 0.0
            for j, (p, m, pk) in enumerate(layers[i0:i0 + g]):
                x_, _, a = _block(p, x_, cfg, i0 + j, positions=positions, masks=m,
                                  pack=pk)
                aux_ = aux_ + a
            return x_, aux_

        for i0 in range(0, cfg.n_layers, g):
            x, a = checkpoint(region, i0, x, use_reentrant=False, **kw)
            aux = aux + a
    else:
        hist = histories if histories is not None else [None] * cfg.n_layers
        for i, (p, m, pk) in enumerate(layers):
            x, kv, a = _block(p, x, cfg, i, positions=positions, masks=m, pack=pk,
                              history=hist[i])
            aux = aux + a
            if collect_states:
                states.append(kv)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), states, aux


def lm_loss(params, cfg, batch, masks=None, pack=None):
    """Mean next-token cross-entropy (chunked over the sequence by
    ``cfg.loss_chunks`` to bound the logits buffer), as the reference's
    ``lm_loss``, plus 0.01 times the MoE layers' load-balancing loss (0
    without experts).  With ``masks`` the params are RAW and the topology
    is enforced inside the kernels, so autograd of this w.r.t. the params
    yields the sparse (or superset-supported) gradient directly.  A
    ``patch`` config scores only the last T (the text's) positions."""
    h, _, aux = lm_forward(params, cfg, batch, masks=masks, pack=pack,
                           collect_states=False)
    targets = batch["targets"]
    if cfg.frontend == "patch":
        h = h[:, -targets.shape[1]:]
    B, S, _ = h.shape
    n_chunks = max(1, cfg.loss_chunks)
    if S % n_chunks:
        raise ValueError(f"lm_loss: seq {S} does not split into {n_chunks} chunks")
    step = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, step):
        logits = _logits(params, cfg, h[:, s:s + step])
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets[:, s:s + step, None].long())[..., 0]
        total = total + (lse - picked).sum()
    return total / (B * S) + 0.01 * aux


def init_caches(cfg, batch: int, max_len: int, device):
    """Per-layer KV caches in the compute dtype; an xLSTM config's layers
    hold their f32 recurrent states instead (no positional axis), a hymba
    config's both a KV cache and an SSM state (``ssm.init_ssm_state``)."""
    if cfg.block_type == "xlstm":
        init = {"slstm": X.init_slstm_state, "mlstm": X.init_mlstm_state}
        return [{k: init[k](cfg, batch, device)}
                for k in (_state_key(cfg, i) for i in range(cfg.n_layers))]
    dt = compute_dtype(cfg)
    return [
        {"kv": A.init_kv_cache(cfg, cfg.layer_kind(i), batch, max_len, dt, device),
         **_ssm_cache(cfg, batch, device)}
        for i in range(cfg.n_layers)
    ]


def _ssm_cache(cfg, batch: int, device) -> dict:
    """A hymba layer's slot-batched SSM state beside its KV ({} else)."""
    if cfg.block_type != "hymba":
        return {}
    return {"ssm": S.init_ssm_state(cfg, batch, device)}


def cache_group(cfg, i: int) -> str:
    """The page-pool group of layer i's KV cache: 'local' (a ring of
    min(window, max_len)) or 'global' (max_len).  Layers of one group share
    one page id space (``serving/block_pool.py``)."""
    return "local" if (cfg.layer_kind(i) == "local" and cfg.window) else "global"


def init_paged_caches(cfg, n_blocks: dict, page_size: int, device, *,
                      batch: int = 0):
    """Paged ``init_caches``: each layer's KV leaves are a page pool of
    ``n_blocks[cache_group(cfg, i)]`` pages (``attention.init_kv_pool``);
    the serving engine owns the tables.  Recurrent per-slot states (an
    xLSTM config's, a hymba config's SSM) have no positional axis to page:
    they stay slot-batched at ``batch`` rows, as in ``init_caches``."""
    if cfg.block_type == "xlstm":
        return init_caches(cfg, batch, 0, device)
    dt = compute_dtype(cfg)
    return [
        {"kv": A.init_kv_pool(cfg, n_blocks[cache_group(cfg, i)], page_size,
                              dt, device),
         **_ssm_cache(cfg, batch, device)}
        for i in range(cfg.n_layers)
    ]


def lm_prefill(params, cfg, batch, max_len: int, *, masks=None, pack=None,
               n_valid=None):
    """Run the prompt -> (last-position logits (B, 1, V), filled caches).

    ``n_valid``: positions >= n_valid are end padding (the engine buckets
    prompt lengths): their K/V writes are dropped and the logits come from
    position n_valid - 1.  Exact for causal attention stacks, not for the
    recurrent xLSTM and SSM states (they would integrate the pad steps: the
    engine prefills those at the exact length).

    A hymba layer's SSM state takes the scan's final h and, as the conv
    state, the last 3 pre-conv inputs u, rounded to the compute dtype as
    the reference's cache rounds them.  The reference recomputes
    ``in_proj`` on the prompt for these rows; they are the rows of the same
    product the SSM already ran, so the port takes them from it.  A hymba
    prompt needs at least 3 tokens (the conv state's rows).

    A ``patch`` config's batch may carry ``patches`` (B, n_patches,
    frontend_dim): their rows come first, so the K/V rows and ``n_valid``
    count them.  An encoder config raises (no decode step).
    """
    _check_decodes(cfg, "lm_prefill")
    last = _seq_len(cfg, batch) if n_valid is None else n_valid
    if cfg.block_type == "hymba" and last < S.CONV_WIDTH - 1:
        raise ValueError(
            f"lm_prefill: a hymba prompt needs at least {S.CONV_WIDTH - 1} tokens "
            f"(the SSM's conv state holds the last {S.CONV_WIDTH - 1} inputs; got {last})")
    h, states, _ = lm_forward(params, cfg, batch, masks=masks, pack=pack)
    if cfg.block_type == "xlstm":
        caches = [{_state_key(cfg, i): st} for i, st in enumerate(states)]
    else:
        caches = init_caches(cfg, h.shape[0], max_len, h.device)
        for c, st in zip(caches, states):
            if cfg.block_type == "hymba":
                st, ssm_h, u = st
                c["ssm"]["h"].copy_(ssm_h)
                c["ssm"]["conv"].copy_(u[:, last - S.CONV_WIDTH + 1:last].to(
                    compute_dtype(cfg)))
            A.fill_kv_cache(c["kv"], *st, 0, n_valid=n_valid)
    return _logits(params, cfg, h[:, last - 1:last]), caches


def lm_prefill_into(params, cfg, caches, batch, slot: int, max_len: int, *,
                    masks=None, pack=None, n_valid=None, tables=None):
    """Prefill ONE prompt (B=1) and write its cache row into ``caches`` at
    ``slot``, in place; stale positions beyond the prompt stay, since decode
    never attends a position before the write that owns it.  Returns
    (logits (1, 1, V), caches).

    ``tables`` ({'global'/'local': (T_g,) int32} page tables of this
    request's row, on the device) switches ``caches`` to the paged layout
    (``init_paged_caches``): the same B=1 prefill, then its row scatters
    page by page through the group's table (``attention.fill_kv_pool``),
    which is what makes paged admission token-identical to contiguous.
    An xLSTM config's recurrent state rows, and a hymba config's SSM rows,
    are written at ``slot`` in either layout."""
    logits, row = lm_prefill(params, cfg, batch, max_len, masks=masks,
                             pack=pack, n_valid=n_valid)
    if cfg.block_type == "xlstm":
        for i, (c, r) in enumerate(zip(caches, row)):
            key = _state_key(cfg, i)
            for name, leaf in c[key].items():
                leaf[slot] = r[key][name][0]
        return logits, caches
    for i, (c, r) in enumerate(zip(caches, row)):
        for name, leaf in c.get("ssm", {}).items():
            leaf[slot] = r["ssm"][name][0]
        if tables is not None:
            A.fill_kv_pool(c["kv"], r["kv"], tables[cache_group(cfg, i)])
            continue
        for name in ("k", "v"):
            c["kv"][name][slot] = r["kv"][name][0]
    return logits, caches


def lm_prefill_suffix(params, cfg, caches, batch, table, ctx: int, *,
                      masks=None, pack=None, n_valid=None):
    """Prefill only the SUFFIX of a prompt whose first ``ctx`` positions are
    already in the paged pools (shared-prefix admission): the shared pages'
    K/V are never recomputed.

    caches: paged (``init_paged_caches``); table: (T,) int32 global-group
    page table of the request on the device (shared or forked prefix pages
    first, unowned tail = sentinel); ctx: the cached prefix length, a host
    int (the engine knows it); batch: B=1 suffix tokens from position ctx,
    bucket-padded, ``n_valid`` of them true.  Suffix queries attend [the
    table's prefix, causal self] (``attention._attend_with_history``) with
    RoPE at ctx + arange(S); the suffix K/V then scatter at positions ctx..
    (``attention.fill_kv_pool_suffix``), in place.  Returns (logits at
    suffix position n_valid - 1, caches).  All-global causal transformer
    stacks only."""
    if not cfg.causal or any(cache_group(cfg, i) != "global"
                             for i in range(cfg.n_layers)):
        raise ValueError("lm_prefill_suffix: all-global causal stacks only")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    dev = tokens.device
    positions = ctx + torch.arange(S, device=dev)
    ctx_d = torch.full((1,), ctx, dtype=torch.int32, device=dev)
    histories = [{"pool": c["kv"], "table": table[None], "ctx": ctx_d}
                 for c in caches]
    h, states, _ = lm_forward(params, cfg, batch, masks=masks, pack=pack,
                              positions=positions, histories=histories)
    n = S if n_valid is None else n_valid
    for c, (k, v) in zip(caches, states):
        A.fill_kv_pool_suffix(c["kv"], k, v, table, ctx, n)
    return _logits(params, cfg, h[:, n - 1:n]), caches


def logits_all_finite(logits):
    """(B, ...) -> (B,) bool: every logit of the row is finite (vocab pads
    are the finite -1e30, so a NaN/Inf is a real fault on that slot)."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)


def _gate_rows(active, new, old) -> None:
    """Write a recurrent state's ``new`` rows into ``old`` IN PLACE, only
    where ``active`` (B,) bool (every row when None): the reference's
    ``_gate_rows``, so a parked slot's state stays bit for bit.  In place,
    the step's state tensors are the same across calls, so a decode step
    can be captured and replayed as a CUDA graph."""
    for name, o in old.items():
        n = new[name]
        if active is not None:
            n = torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
        o.copy_(n)


def lm_decode(params, cfg, caches, tokens, pos, *, masks=None, pack=None,
              active=None, tables=None):
    """One decode step.  tokens: (B, 1) int; pos: int or (B,) tensor;
    ``active`` (B,) bool leaves inactive rows' caches untouched and keeps
    them out of an MoE's routing (a parked slot takes no expert capacity).
    ``tables`` ({group: (B, T_g) int32} on the device) switches to the
    paged layout (``attention.attn_decode(table=)``).  An xLSTM config's
    layers step their recurrent states (``pos`` and ``tables`` unused),
    a hymba config's their SSM states beside the KV; inactive rows frozen.
    Returns (logits (B, 1, V), caches updated in place).  An encoder
    config raises."""
    _check_ported(cfg)
    _check_decodes(cfg, "lm_decode")
    x = _embed(params, cfg, {"tokens": tokens})
    for i, (p, m, pk, c) in enumerate(zip(
            params["layers"], _per_layer(masks, cfg), _per_layer(pack, cfg),
            caches)):
        if cfg.block_type == "xlstm":
            key = _state_key(cfg, i)
            step = X.slstm_decode if key == "slstm" else X.mlstm_decode
            o, new = step(p[key], rmsnorm(p["ln1"], x, cfg.norm_eps), c[key], cfg,
                          masks=_sub(m, key), pack=_sub(pk, key))
            _gate_rows(active, new, c[key])
            x = x + o
            continue
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_out, c["kv"] = A.attn_decode(
            p["attn"], h, c["kv"], pos, cfg, kind=cfg.layer_kind(i),
            masks=_sub(m, "attn"), pack=_sub(pk, "attn"), active=active,
            table=None if tables is None else tables[cache_group(cfg, i)],
        )
        if cfg.block_type == "hymba":
            ssm_out, new = S.ssm_decode(p["ssm"], h, c["ssm"], cfg,
                                        masks=_sub(m, "ssm"), pack=_sub(pk, "ssm"))
            _gate_rows(active, new, c["ssm"])
            attn_out = _hymba_mix(p, attn_out, ssm_out, cfg)
        x = _join(p, x, h, attn_out, cfg, m, pk, active)[0]
    return _logits(params, cfg, rmsnorm(params["ln_f"], x, cfg.norm_eps)), caches
