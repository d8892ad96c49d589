"""Mamba-style selective SSM head of the port (Hymba's parallel-SSM branch),
the JAX package's ``models/ssm.py``.

The state h (B, d_in, N) follows the linear recurrence h_t = a_t * h_{t-1}
+ b_t with a_t = exp(dt_t A) and b_t = (dt_t u_t) B_t.  The full-sequence
forward carries h across chunks of ``chunk`` steps (the reference's Python
loop over chunks); within a chunk the recurrence is a log-depth doubling
scan over time (``_doubling_scan``: the reference's
``jax.lax.associative_scan`` with the same combine, (l_a r_a, r_a l_b +
r_b), summed in another order).  ``_Scan`` gives the chunk's scan its own
backward, the same doubling scan reversed in time, so autograd keeps a and
h of a chunk and not the scan's log2(chunk) intermediate levels.  Decode is
the single-step recurrence.

Sparse-kernel dispatch, as in the reference: ``in_proj`` (d, 2 d_in) and
``out_proj`` (d_in, d) route through ``layers.linear`` with their mask
leaves (K1 / K13 forward, K2-K3 / K14-K15 backward); the scan's internals
(``w_bc``, ``w_dt``, the conv, the gates, the recurrence) are dense plain
PyTorch and carry no masks.  Every SSM tensor inherits the f32 residual's
dtype (``linear`` with no compute dtype), as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (
    P,
    assert_total_dispatch,
    conv1d_causal,
    conv1d_causal_init,
    conv1d_causal_step,
    dispatch_kw,
    linear,
)

__all__ = ["ssm_init", "ssm", "ssm_decode", "init_ssm_state"]

# sparse matmul leaves routed through the kernels (assert_total_dispatch)
_DISPATCHED = ("in_proj", "out_proj")
CONV_WIDTH = 4


def ssm_init(gen: torch.Generator, cfg, *, sparse: bool = True):
    """The reference's tree: ``in_proj/w`` and ``out_proj/w`` sparse;
    ``conv/{w,b}``, ``w_bc/w``, ``w_dt/w``, ``a_log``, ``d_skip`` and
    ``dt_bias`` dense (torch's draws, the reference's distributions)."""
    d, d_in, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dev = gen.device

    def lin(nin, nout, axes, sp):
        return {"w": P(torch.randn(nin, nout, generator=gen, device=dev) / np.sqrt(nin),
                       axes, sp)}

    u = torch.rand(d_in, N, generator=gen, device=dev)
    a_init = -torch.exp(np.log(0.5) + u * (np.log(8.0) - np.log(0.5)))
    return {
        "in_proj": lin(d, 2 * d_in, ("embed", "mlp"), sparse),
        "conv": conv1d_causal_init(gen, d_in, CONV_WIDTH),
        "w_bc": lin(d_in, 2 * N, ("mlp", None), False),
        "w_dt": lin(d_in, d_in, ("mlp", "mlp2"), False),
        "a_log": P(torch.log(-a_init), ("mlp", "state")),
        "d_skip": P(torch.ones(d_in, device=dev), ("mlp",)),
        "dt_bias": P(torch.zeros(d_in, device=dev), ("mlp",)),
        "out_proj": lin(d_in, d, ("mlp", "embed"), sparse),
    }


def _gates(p, x, cfg, masks=None, pack=None):
    """x -> (u, z), the two halves of ``in_proj``."""
    d_in = cfg.ssm_d_inner
    uz = linear(p["in_proj"], x, **dispatch_kw(cfg, masks, "in_proj", pack))
    return uz[..., :d_in], uz[..., d_in:]


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _selective(p, u, cfg):
    """u (B, S, d_in) -> a, b (B, S, d_in, N) f32 and C (B, S, N)."""
    N = cfg.ssm_state
    bc = linear(p["w_bc"], u)
    Bt, Ct = bc[..., :N], bc[..., N:]
    dt = _softplus(linear(p["w_dt"], u) + p["dt_bias"].to(u.dtype))
    A = -torch.exp(p["a_log"]).float()  # (d_in, N)
    a = torch.exp(dt.float()[..., None] * A)
    b = (dt * u).float()[..., None] * Bt.float()[..., None, :]
    return a, b, Ct


def _doubling_scan(a, b):
    """Inclusive scan of (a, b) along dim 1 under the combine (l_a r_a,
    r_a l_b + r_b): after level j, position t holds the combination of
    steps (t - 2^j, t].  Returns (the running product of a, the recurrence
    from a zero state).  Works on copies; log2(L) levels."""
    a, b = a.clone(), b.clone()
    L, off = a.shape[1], 1
    while off < L:
        b[:, off:] += a[:, off:] * b[:, :-off]
        a[:, off:] *= a[:, :-off].clone()
        off *= 2
    return a, b


class _Scan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t over one chunk from h0 -> h (B, L, d_in, N).

    Backward: g_t = dh_t + a_{t+1} g_{t+1} (the same scan reversed in
    time), then da_t = g_t h_{t-1}, db_t = g_t, dh0 = a_0 g_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        cum_a, acc = _doubling_scan(a, b)
        h = acc.add_(cum_a.mul_(h0[:, None]))
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
        _, g = _doubling_scan(a_next.flip(1), dh.flip(1))
        g = g.flip(1)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], 1)
        return g * h_prev, g, a[:, 0] * g[:, 0]


def ssm(p, x, cfg, *, chunk: int = 1024, h0=None, masks=None, pack=None,
        with_u: bool = False):
    """Selective-SSM forward: x (B, S, d) -> (out (B, S, d), final state
    h (B, d_in, N) f32).  ``masks``/``pack``: this SSM's mask and PackState
    subtrees (``in_proj`` and ``out_proj`` dispatch through the kernels).
    ``with_u`` also returns the pre-conv inner activations u (B, S, d_in):
    a prefill takes the conv state from their last rows."""
    assert_total_dispatch(masks, _DISPATCHED, kernel=cfg.sparse.kernel, where="ssm")
    B, S, _ = x.shape
    u_raw, z = _gates(p, x, cfg, masks, pack)
    u = F.silu(conv1d_causal(p["conv"], u_raw))
    a, b, Ct = _selective(p, u, cfg)
    if h0 is None:
        h0 = torch.zeros(B, cfg.ssm_d_inner, cfg.ssm_state, device=x.device)
    ys = []
    for s in range(0, S, chunk):
        e = min(s + chunk, S)
        h = _Scan.apply(a[:, s:e], b[:, s:e], h0)
        # (B, L, d_in, N) @ (B, L, N, 1): C_t . h_t per inner channel
        ys.append(torch.matmul(h, Ct[:, s:e].float()[..., None])[..., 0])
        h0 = h[:, -1]
    y = torch.cat(ys, 1).to(x.dtype)
    y = y + u * p["d_skip"].to(u.dtype)
    y = y * F.silu(z)
    out = linear(p["out_proj"], y, **dispatch_kw(cfg, masks, "out_proj", pack))
    return (out, h0, u_raw) if with_u else (out, h0)


def init_ssm_state(cfg, batch: int, device):
    """A slot's zero state: h (B, d_in, N) and the conv's last inputs
    (B, 3, d_in), both f32.  The reference's conv state is in the compute
    dtype; a prefill rounds the rows it writes to that dtype
    (``model.lm_prefill``), the only place the reference rounds them
    (its first decode step promotes the state to f32)."""
    return {
        "h": torch.zeros(batch, cfg.ssm_d_inner, cfg.ssm_state, device=device),
        "conv": torch.zeros(batch, CONV_WIDTH - 1, cfg.ssm_d_inner, device=device),
    }


def ssm_decode(p, x_t, state, cfg, *, masks=None, pack=None):
    """One token: x_t (B, 1, d), state {"h", "conv"} -> (out (B, 1, d), new
    state).  The state is not written: the caller owns the in-place
    update."""
    assert_total_dispatch(masks, _DISPATCHED, kernel=cfg.sparse.kernel,
                          where="ssm_decode")
    u, z = _gates(p, x_t, cfg, masks, pack)
    conv, u1 = conv1d_causal_step(p["conv"], state["conv"], u[:, 0])
    u = F.silu(u1)[:, None, :]
    a, b, Ct = _selective(p, u, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = torch.matmul(h, Ct[:, 0].float()[..., None])[..., 0].to(x_t.dtype)
    y = y + u[:, 0] * p["d_skip"].to(u.dtype)
    y = (y * F.silu(z[:, 0]))[:, None, :]
    out = linear(p["out_proj"], y, **dispatch_kw(cfg, masks, "out_proj", pack))
    return out, {"h": h, "conv": conv}
