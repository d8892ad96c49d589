"""The paper's §4.2 character LM of the port: embed(128) -> GRU(512) ->
256 -> 128 -> vocab 256, the JAX package's ``models/gru.py``.

The GRU kernels ``wx``/``wh`` and the readouts ``ro1``/``ro2``/``head``
are RigL-sparsifiable (the paper sparsifies them to 75%); the embedding
and the bias stay dense.  As in the reference, nothing here dispatches to
a sparse kernel: callers pass pre-masked weights and every product is a
plain f32 matmul.  The reference's ``lax.scan`` over time is a Python
loop.  Layout as the reference's ``gru_lm_init``; the draws are torch's,
not ``jax.random``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import P, linear, linear_init, split_params

__all__ = ["gru_init", "gru_apply", "gru_lm_init", "gru_lm_apply"]


def _p(gen, shape, sparse):
    w = torch.randn(shape, generator=gen, device=gen.device) / np.sqrt(shape[0])
    return {"w": P(w, ("embed", "mlp"), sparse)}


def gru_init(gen: torch.Generator, n_in: int, n_state: int, *, sparse: bool = True):
    return {
        "wx": _p(gen, (n_in, 3 * n_state), sparse),
        "wh": _p(gen, (n_state, 3 * n_state), sparse),
        "b": P(torch.zeros(3 * n_state, device=gen.device), (None,)),
    }


def gru_apply(p, x, h0=None):
    """x: (B, S, n_in) -> (hs (B, S, n_state), final h).  Gates r, z and
    the candidate c in the reference's order and split of ``wh``."""
    B, S, _ = x.shape
    n = p["wh"]["w"].shape[0]
    wx = linear(p["wx"], x, torch.float32) + p["b"]  # (B, S, 3n)
    h = torch.zeros(B, n, device=x.device) if h0 is None else h0
    wh = p["wh"]["w"]
    wh_rz, wh_c = wh[:, :2 * n], wh[:, 2 * n:]
    hs = []
    for t in range(S):
        wx_t = wx[:, t]
        rz_h = h @ wh_rz
        r = torch.sigmoid(wx_t[:, :n] + rz_h[:, :n])
        z = torch.sigmoid(wx_t[:, n:2 * n] + rz_h[:, n:])
        c = torch.tanh(wx_t[:, 2 * n:] + (r * h) @ wh_c)
        h = (1 - z) * c + z * h
        hs.append(h)
    return torch.stack(hs, dim=1), h


def gru_lm_init(gen: torch.Generator, vocab: int = 256, d_embed: int = 128,
                d_state: int = 512):
    """The paper's exact architecture (its Appendix I) -> (params,
    sparse_flags), f32 on the generator's device."""
    dev = gen.device
    tree = {
        "embed": {"table": P(0.02 * torch.randn(vocab, d_embed, generator=gen, device=dev),
                             ("vocab", "embed"))},
        "gru": gru_init(gen, d_embed, d_state),
        "ro1": linear_init(gen, d_state, 256, ("embed", "mlp")),
        "ro2": linear_init(gen, 256, 128, ("embed", "mlp")),
        "head": linear_init(gen, 128, vocab, ("embed", "vocab")),
    }
    params, _, flags = split_params(tree)
    return params, flags


def gru_lm_apply(params, tokens):
    """tokens: (B, S) int -> logits (B, S, vocab) f32."""
    x = params["embed"]["table"][tokens.long()]
    hs, _ = gru_apply(params["gru"], x)
    h = torch.relu(linear(params["ro1"], hs, torch.float32))
    h = torch.relu(linear(params["ro2"], h, torch.float32))
    return linear(params["head"], h, torch.float32)
