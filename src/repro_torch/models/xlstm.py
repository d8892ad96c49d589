"""xLSTM blocks of the port (Beck et al. 2024, arXiv:2405.04517): mLSTM
and sLSTM, the JAX package's ``models/xlstm.py``.

mLSTM: a matrix memory C (hd x hd per head) with exponential gating.  The
full-sequence forward is the chunkwise stabilised parallel form (quadratic
within a chunk of ``cfg.q_chunk``, recurrent across chunks); decode is the
O(1) recurrence.  sLSTM: a scalar memory with per-head recurrent weights,
a true nonlinear recurrence, stepped in a Python loop over time (the
reference's ``lax.scan``).

Sparse-kernel dispatch, as in the reference: every RigL-sparsifiable
weight is a matmul routed by ``cfg.sparse.kernel`` -- mLSTM's ``wq``,
``wk``, ``wv``, ``wz``, ``wo`` and sLSTM's ``w_in``, ``wo`` through
``layers.linear`` (K1 / K13 and their backward kernels), and sLSTM's
per-head recurrent bank ``r`` (nh, hd, 4 hd), a bare leaf with no ``"w"``
bundle, through ``layers.grouped_linear`` with the head dim leading: one
grouped launch (K4 / K16) per time step.  The gates ``w_if`` and the norms
stay dense.

The stabiliser ``m`` starts at -1e30 in f32 and carries gradients (no
detach), as in the reference; ``torch.amax``/``torch.maximum`` split a
tie's gradient evenly, as ``jnp.max``/``jnp.maximum`` do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (
    P,
    assert_total_dispatch,
    dispatch_kw,
    grouped_linear,
    linear,
    rmsnorm,
    rmsnorm_init,
)

__all__ = [
    "mlstm_init",
    "mlstm",
    "mlstm_decode",
    "init_mlstm_state",
    "slstm_init",
    "slstm",
    "slstm_decode",
    "init_slstm_state",
]

# sparse matmul leaves routed through the kernels (assert_total_dispatch)
_MLSTM_DISPATCHED = ("wq", "wk", "wv", "wz", "wo")
_SLSTM_DISPATCHED = ("w_in", "r", "wo")
_M0 = -1e30  # the stabiliser's start


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device) / np.sqrt(shape[-2])


def _lin(gen, nin, nout, axes, sparse):
    return {"w": P(_normal(gen, (nin, nout)), axes, sparse)}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, *, sparse: bool = True):
    d, nh = cfg.d_model, cfg.n_heads
    return {
        "wq": _lin(gen, d, d, ("embed", "heads"), sparse),
        "wk": _lin(gen, d, d, ("embed", "heads"), sparse),
        "wv": _lin(gen, d, d, ("embed", "heads"), sparse),
        "w_if": _lin(gen, d, 2 * nh, ("embed", None), False),
        "wz": _lin(gen, d, d, ("embed", "heads"), sparse),
        "wo": _lin(gen, d, d, ("heads", "embed"), sparse),
        "norm": rmsnorm_init(d // nh, gen.device, ("head_dim",)),
    }


def _mlstm_qkv(p, x, cfg, masks=None, pack=None):
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    q = linear(p["wq"], x, **dispatch_kw(cfg, masks, "wq", pack)).reshape(B, S, nh, hd)
    k = linear(p["wk"], x, **dispatch_kw(cfg, masks, "wk", pack)).reshape(
        B, S, nh, hd) / float(np.sqrt(hd))
    v = linear(p["wv"], x, **dispatch_kw(cfg, masks, "wv", pack)).reshape(B, S, nh, hd)
    gif = linear(p["w_if"], x).float()  # (B, S, 2 nh)
    return q, k, v, gif[..., :nh], F.logsigmoid(gif[..., nh:])


def init_mlstm_state(cfg, batch: int, device):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return {
        "C": torch.zeros(batch, nh, hd, hd, device=device),
        "n": torch.zeros(batch, nh, hd, device=device),
        "m": torch.full((batch, nh), _M0, device=device),
    }


def mlstm(p, x, cfg, *, chunk: int = 1024, state=None, masks=None, pack=None):
    """Chunkwise parallel mLSTM: x (B, S, d) -> (out (B, S, d), final
    state {"C", "n", "m"}).  ``masks``/``pack``: this block's mask and
    PackState subtrees (the five projections dispatch through the
    kernels)."""
    assert_total_dispatch(masks, _MLSTM_DISPATCHED, kernel=cfg.sparse.kernel,
                          where="mlstm")
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    q, k, v, i_pre, logf = _mlstm_qkv(p, x, cfg, masks, pack)
    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    C, n, m = state["C"], state["n"], state["m"]

    outs = []
    for s in range(0, S, min(chunk, S)):
        e = min(s + chunk, S)
        L = e - s
        qc, kc, vc = q[:, s:e], k[:, s:e], v[:, s:e]
        ic, fc = i_pre[:, s:e], logf[:, s:e]

        Fc = torch.cumsum(fc, dim=1)  # (B, L, nh) cumulative log f in the chunk
        # intra-chunk log decay D[t, u] = F_t - F_u + i_u (u <= t)
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]  # (B, t, u, nh)
        tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        D = torch.where(tril[None, :, :, None], D, -torch.inf)
        m_intra = torch.amax(D, dim=2)  # (B, L, nh)
        m_t = torch.maximum(Fc + m[:, None, :], m_intra)

        scores = torch.einsum("blnh,bunh->blun", qc.float(), kc.float())
        w = scores * torch.exp(D - m_t[:, :, None, :])
        num_intra = torch.einsum("blun,bunh->blnh", w.to(vc.dtype), vc).float()
        den_intra = w.sum(2)  # (B, L, nh)

        inter_scale = torch.exp(Fc + m[:, None, :] - m_t)
        qC = torch.einsum("blnh,bnhv->blnv", qc.float(), C)
        qn = torch.einsum("blnh,bnh->bln", qc.float(), n)
        num = num_intra + inter_scale[..., None] * qC
        den = den_intra + inter_scale * qn
        denom = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append((num / denom[..., None]).to(x.dtype))  # (B, L, nh, hd)

        # the state at the chunk's end
        F_L = Fc[:, -1]  # (B, nh)
        m_new = torch.maximum(F_L + m, torch.amax(F_L[:, None] - Fc + ic, dim=1))
        wgt = torch.exp(F_L[:, None] - Fc + ic - m_new[:, None])  # (B, L, nh)
        decay = torch.exp(F_L + m - m_new)
        C = decay[:, :, None, None] * C + torch.einsum(
            "bunh,bunv,bun->bnhv", kc.float(), vc.float(), wgt)
        n = decay[:, :, None] * n + torch.einsum("bunh,bun->bnh", kc.float(), wgt)
        m = m_new

    h = rmsnorm(p["norm"], torch.cat(outs, dim=1))  # (B, S, nh, hd)
    h = h.reshape(B, S, d) * F.silu(linear(p["wz"], x, **dispatch_kw(cfg, masks, "wz", pack)))
    out = linear(p["wo"], h, **dispatch_kw(cfg, masks, "wo", pack))
    return out, {"C": C, "n": n, "m": m}


def mlstm_decode(p, x_t, state, cfg, *, masks=None, pack=None):
    """One recurrence step: x_t (B, 1, d) -> (out (B, 1, d), new state).
    The state is not written: the caller owns the in-place update."""
    assert_total_dispatch(masks, _MLSTM_DISPATCHED, kernel=cfg.sparse.kernel,
                          where="mlstm_decode")
    B, _, d = x_t.shape
    q, k, v, i_pre, logf = _mlstm_qkv(p, x_t, cfg, masks, pack)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i_pre, logf = i_pre[:, 0], logf[:, 0]  # (B, nh)

    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)[:, :, None, None]
    i_s = torch.exp(i_pre - m_new)[:, :, None, None]
    C = f_s * C + i_s * torch.einsum("bnh,bnv->bnhv", k, v)
    n = f_s[..., 0] * n + i_s[..., 0] * k
    num = torch.einsum("bnh,bnhv->bnv", q, C)
    den = torch.einsum("bnh,bnh->bn", q, n)
    denom = torch.maximum(den.abs(), torch.exp(-m_new))
    h = (num / denom[..., None]).to(x_t.dtype)[:, None]  # (B, 1, nh, hd)
    h = rmsnorm(p["norm"], h).reshape(B, 1, d) * F.silu(
        linear(p["wz"], x_t, **dispatch_kw(cfg, masks, "wz", pack)))
    out = linear(p["wo"], h, **dispatch_kw(cfg, masks, "wo", pack))
    return out, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, *, sparse: bool = True):
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    return {
        "w_in": _lin(gen, d, 4 * d, ("embed", "heads"), sparse),
        "r": P(_normal(gen, (nh, hd, 4 * hd)), ("kv_heads", "head_dim", None), sparse),
        "wo": _lin(gen, d, d, ("heads", "embed"), sparse),
        "norm": rmsnorm_init(hd, gen.device, ("head_dim",)),
    }


def init_slstm_state(cfg, batch: int, device):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    z = lambda: torch.zeros(batch, nh, hd, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, nh, hd), _M0, device=device)}


def _recurrent(p, h, cfg, masks=None, pack=None):
    """The per-head recurrent projection ``bnh,nhk->bnk`` on the (nh, hd,
    4 hd) bank ``r``: the head dim moves leading ((B, nh, hd) -> (nh, B,
    hd)) so it is a grouped matmul, group g computing h[:, g] @ r[g], one
    grouped launch over all heads."""
    rec = grouped_linear(
        p["r"], h.transpose(0, 1).contiguous(), torch.float32,
        mask=None if masks is None else masks["r"],
        kernel=cfg.sparse.kernel, block=cfg.sparse.kernel_block,
        pack=None if pack is None else pack["r"],
    )
    return rec.transpose(0, 1)  # (B, nh, 4 hd)


def _slstm_cell(p, state, wx_t, cfg, masks=None, pack=None):
    """wx_t: (B, 4 d), the input's contribution at step t -> new state."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    B = wx_t.shape[0]
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    g = wx_t.reshape(B, nh, 4 * hd).float() + _recurrent(p, h, cfg, masks, pack)
    z_pre, i_pre, f_pre, o_pre = torch.split(g, hd, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * torch.tanh(z_pre)
    n = f_s * n + i_s
    h_new = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h_new, "m": m_new}


def slstm(p, x, cfg, *, state=None, masks=None, pack=None):
    """sLSTM forward: x (B, S, d) -> (out, final state), one cell step
    (one grouped launch for ``r``) per time step."""
    assert_total_dispatch(masks, _SLSTM_DISPATCHED, kernel=cfg.sparse.kernel,
                          where="slstm")
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    wx = linear(p["w_in"], x, **dispatch_kw(cfg, masks, "w_in", pack))  # (B, S, 4d)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, state, wx[:, t], cfg, masks, pack)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, nh, hd)
    h = rmsnorm(p["norm"], h).reshape(B, S, d)
    return linear(p["wo"], h, **dispatch_kw(cfg, masks, "wo", pack)), state


def slstm_decode(p, x_t, state, cfg, *, masks=None, pack=None):
    """One decode step -> (out (B, 1, d), new state); the state is not
    written (the caller owns the in-place update)."""
    assert_total_dispatch(masks, _SLSTM_DISPATCHED, kernel=cfg.sparse.kernel,
                          where="slstm_decode")
    B, _, d = x_t.shape
    wx = linear(p["w_in"], x_t, **dispatch_kw(cfg, masks, "w_in", pack))[:, 0]
    state = _slstm_cell(p, state, wx, cfg, masks, pack)
    h = rmsnorm(p["norm"], state["h"][:, None].to(x_t.dtype)).reshape(B, 1, d)
    return linear(p["wo"], h, **dispatch_kw(cfg, masks, "wo", pack)), state
