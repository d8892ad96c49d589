"""Flash attention on tight, schedule-driven KV walks, forward and backward.

Replaces three TPU kernels of ``repro/kernels/flash_attention.py`` with
hand-written CUDA kernels for Hopper (sm_90a); the designs are described in
the sources:

  K9  ``_fwd_kernel`` (``_fwd_call``)  o and the row logsumexp, walking
      ``kv_idx[qb, :kv_cnt[qb]]``              -> csrc/flash_fwd.cu
  K10 ``_dq_kernel`` (``_dq_call``)    dq on the same walk -> csrc/flash_bwd.cu
  K11 ``_dkv_kernel`` (``_dkv_call``)  dk and dv on the transposed walk
      ``q_idx[kb, :q_cnt[kb]]``, summed over each GQA group -> csrc/flash_bwd.cu

The walks come from a host-built AttnSchedule (``core/attn_sched.py``); the
causal, sliding-window, ``q_offset`` and padded-key masks are applied in the
kernels, GQA is folded (q row b reads KV row b // G) and an optional
``c*tanh(s/c)`` softcap is applied (with its 1 - t^2 chain factor in the
backward).

Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at prefill and
training lengths the work is 4*d (forward), 6*d (dq) and 8*d (dk/dv) flops
per live (q, k) pair against q, k, v, o, do and the row statistics read
once, so the bound is usually the tensor cores.

``flash_fwd``, ``flash_dq`` and ``flash_dkv`` launch their kernels for CUDA
tensors (bf16 only) and take the plain versions (``flash_attention_plain``,
``flash_bwd_plain``) only for CPU tensors.  ``launches``, ``dq_launches``
and ``dkv_launches`` count kernel launches.  ``flash_attention`` is the
public wrapper of the reference (``flash_attention.py:666``): block
clamping, padding to (bq, bk), the AttnSchedule of those shapes and the
``FlashAttention`` autograd Function (the reference's ``_flash`` custom VJP:
forward K9, backward delta = rowsum(do * o) in f32, then K10 and K11).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.attn_sched import sched_for
from . import _build

__all__ = [
    "FlashAttention",
    "effective_blocks",
    "flash_attention",
    "flash_attention_plain",
    "flash_bwd",
    "flash_bwd_plain",
    "flash_dkv",
    "flash_dq",
    "flash_fwd",
    "grad_error_bound",
    "launches",
    "dq_launches",
    "dkv_launches",
    "o_error_bound",
]

NEG_INF = -1e30
EPS = 1e-30

# kernel launches since import (or since a caller reset them)
launches = 0      # K9
dq_launches = 0   # K10
dkv_launches = 0  # K11


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def effective_blocks(sq: int, sk: int, bq: int = 128, bk: int = 128):
    """The (bq, bk) ``flash_attention`` runs for these lengths (tiles clamp
    to the 16-padded length for short sequences).  A caller that runs
    ``flash_fwd`` or the plain version on the padded layout itself builds
    its schedule at these blocks."""
    return min(bq, _round_up(sq, 16)), min(bk, _round_up(sk, 16))


def _schedule_mask(kv_idx, kv_cnt, n_k: int, device) -> torch.Tensor:
    """(n_q, n_k) bool: the KV blocks the schedule lets each q-block see."""
    idx = torch.as_tensor(kv_idx, device=device).long()
    cnt = torch.as_tensor(kv_cnt, device=device)
    live = torch.arange(idx.shape[1], device=device)[None, :] < cnt[:, None]
    rows = torch.arange(idx.shape[0], device=device)[:, None].expand_as(idx)
    out = torch.zeros(idx.shape[0], n_k, dtype=torch.bool, device=device)
    out[rows[live], idx[live]] = True
    return out


def _visible(Sqp: int, Skp: int, blocks, *, bq: int, bk: int, causal: bool,
             window: int, q_offset: int, sk: int, device) -> torch.Tensor:
    """(Sqp, Skp) bool: the elementwise mask (causal, window, padded keys)
    AND the schedule's (n_q, n_k) block visibility ``blocks``."""
    qpos = q_offset + torch.arange(Sqp, device=device)[:, None]
    kpos = torch.arange(Skp, device=device)[None, :]
    mask = kpos < sk
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask & blocks.repeat_interleave(bq, 0).repeat_interleave(bk, 1)


def _scores(q, k, rows, kv_groups: int, scale: float, softcap: float):
    """f32 scores of query rows ``rows`` against their KV rows, scaled and
    capped -> (s, t or None, kv row ids); t = tanh(u / c) for the VJP."""
    kv = torch.arange(rows.start, rows.stop, device=q.device) // kv_groups
    s = q[rows].float() @ k[kv].float().transpose(1, 2) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    return s, t, kv


def _chunk(BH: int, Sqp: int, Skp: int):
    """Row chunks of BH that bound the f32 score buffers (2**26 elements)."""
    step = max(1, (1 << 26) // (Sqp * Skp))
    return [slice(b0, min(b0 + step, BH)) for b0 in range(0, BH, step)]


def flash_attention_plain(q, k, v, kv_idx, kv_cnt, *, bq: int, bk: int,
                          causal: bool, window: int, q_offset: int, sk: int,
                          scale: float, softcap: float, kv_groups: int):
    """Plain K9 on the padded layout: the full masked softmax in f32.

    Same arguments and outputs as ``flash_fwd``.  A key is visible when the
    elementwise mask admits it AND its block is on the q-block's schedule;
    rows with no visible key give o = 0 and lse = +1e30.
    """
    BH, Sqp, d = q.shape
    Skp = k.shape[1]
    mask = _visible(Sqp, Skp, _schedule_mask(kv_idx, kv_cnt, Skp // bk, q.device),
                    bq=bq, bk=bk, causal=causal, window=window,
                    q_offset=q_offset, sk=sk, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sqp, dtype=torch.float32, device=q.device)
    for rows in _chunk(BH, Sqp, Skp):
        s, _, kv = _scores(q, k, rows, kv_groups, scale, softcap)
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(-1, keepdim=True)
        o[rows] = ((p @ v[kv].float()) / l.clamp_min(EPS)).to(q.dtype)
        lse[rows] = torch.where(
            l > 0, m + torch.log(l.clamp_min(EPS)), -NEG_INF
        )[..., 0]
    return o, lse


def flash_bwd_plain(q, k, v, do, lse, delta, blocks, *, bq: int, bk: int,
                    causal: bool, window: int, q_offset: int, sk: int,
                    scale: float, softcap: float, kv_groups: int,
                    with_abs: bool = False):
    """Plain K10 + K11 on the padded layout -> (dq, dk, dv), step by step as
    the kernels: p = exp(s - lse) on visible slots (0 elsewhere, so a dead
    row's lse = +1e30 gives 0), ds = p (do v^T - delta) scale (1 - t^2), p
    rounded to do's dtype and ds to q's before the products, f32 sums, each
    output rounded once.  ``blocks`` is the schedule's (n_q, n_k) block
    visibility.

    ``with_abs`` also returns, for ``grad_error_bound``, per output the
    product of the absolute values of its rounded operands (|ds| @ |k|,
    |ds|^T @ |q|, |p|^T @ |do|) and then the propagated bound of the f32
    differences that p and ds carry before their rounding (see
    ``grad_error_bound``)."""
    BH, Sqp, d = q.shape
    Skp = k.shape[1]
    mask = _visible(Sqp, Skp, blocks, bq=bq, bk=bk, causal=causal,
                    window=window, q_offset=q_offset, sk=sk, device=q.device)
    dq = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32)
    if with_abs:
        eps_d = 2.0 * d * 2.0**-24  # f32 dot of length d, two orders
        extra = [torch.zeros(t.shape, **f32) for t in (q, k, v, q, k, v)]
    for rows in _chunk(BH, Sqp, Skp):
        s, t, kv = _scores(q, k, rows, kv_groups, scale, softcap)
        p = torch.where(mask, torch.exp(s - lse[rows, :, None]), 0.0)
        dp = do[rows].float() @ v[kv].float().transpose(1, 2)
        dpd = dp - delta[rows, :, None]
        ds = p * dpd * scale
        if t is not None:
            ds = ds * (1.0 - t * t)
        ds_r = ds.to(q.dtype).float()
        p_r = p.to(do.dtype).float()
        dq[rows] = (ds_r @ k[kv].float()).to(q.dtype)
        dk.index_add_(0, kv, ds_r.transpose(1, 2) @ q[rows].float())
        dv.index_add_(0, kv, p_r.transpose(1, 2) @ do[rows].float())
        if with_abs:
            aq, ak, av, ado = (x.float().abs() for x in (q[rows], k[kv], v[kv], do[rows]))
            du = eps_d * scale * (aq @ ak.transpose(1, 2))   # |u_kernel - u_plain|
            p_err = p * (du + 2.0**-21)                       # + exp's few ulps
            ds_err = (p_err * dpd.abs() + p * eps_d * (ado @ av.transpose(1, 2))) * scale
            if softcap:
                ds_err = ds_err + p * dpd.abs() * scale * 2.0 * du / softcap
            rq, rk, rv, eq, ek, ev = extra
            rq[rows] = ds_r.abs() @ ak
            rk.index_add_(0, kv, ds_r.abs().transpose(1, 2) @ aq)
            rv.index_add_(0, kv, p_r.abs().transpose(1, 2) @ ado)
            eq[rows] = ds_err @ ak
            ek.index_add_(0, kv, ds_err.transpose(1, 2) @ aq)
            ev.index_add_(0, kv, p_err.transpose(1, 2) @ ado)
    out = (dq, dk.to(k.dtype), dv.to(v.dtype))
    return out + tuple(extra) if with_abs else out


def o_error_bound(o_plain: torch.Tensor, o_abs_v: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |o of ``flash_fwd`` - o of the plain version|
    for bf16 q, k, v.  ``o_abs_v`` is the plain version's o for |v| on the
    same q and k: (p @ |v|) / l, the softmax-weighted mean of |v| per row.

    The kernel rounds p to bf16 before p @ v and the plain version does
    not; l is an f32 sum of the unrounded p in both.  Each p moves by at
    most 2**-8 of itself, so o moves by at most 2**-8 * (p @ |v|) / l.  Each
    side rounds o to bf16 once (2**-8 relative each): 2**-7 * |o|.  The
    factor 1.25 covers the f32 rest: the worst-case accumulation error of
    p @ v and l over up to 4096 keys (2 * 4096 * 2**-24 of (p @ |v|) / l,
    an eighth of the first term) and the bf16 rounding of ``o_abs_v``.  A
    row with no visible key has a bound of 0: both must give exactly 0.
    """
    return 2.0**-7 * o_plain.float().abs() + 1.25 * 2.0**-8 * o_abs_v.float()


def grad_error_bound(g_plain, g_rnd, g_err) -> torch.Tensor:
    """Per-element bound on |kernel - plain| for dq, dk or dv of bf16
    inputs; ``g_rnd`` and ``g_err`` come from
    ``flash_bwd_plain(..., with_abs=True)``.

    Before rounding, the kernel's p and ds differ from the plain version's
    by f32 effects it bounds per score slot: s = q.k and dp = do.v summed
    over d in another order (2 d 2**-24 of |q|.|k| and |do|.|v| each), a
    few ulps of exp, and, where dp - delta cancels (a row whose few keys
    make ds nearly 0), that absolute dp error times p; ``g_err`` carries
    those differences through the product (e.g. ds_err @ |k| for dq).  Both
    sides then round p and ds to bf16, which can land one ulp apart: at
    most 2**-7 of the rounded term, hence 2**-7 * ``g_rnd`` (|ds| @ |k|
    for dq).  Each side rounds the output once: 2**-7 * |g|.  The factor
    1.125 covers the two orders of summing the product (up to 4096 terms:
    2 * 4096 * 2**-24 = 2**-11 relative) and second-order terms."""
    return (2.0**-7 * g_plain.float().abs()
            + 1.125 * (2.0**-7 * g_rnd.float() + g_err.float()))


def _check_cuda(what, q, k, v, idx, cnt, n_sched, bq, bk, kv_groups, rows=()):
    """Device, dtypes, contiguity, tiling and alignment of one launch.
    ``n_sched`` is the schedule's row count; ``rows`` lists the (BH, Sqp)
    f32 row statistics (lse, delta) and ``(BH, Sqp, d)`` bf16 tensors (do)
    that ride along."""
    BH, Sqp, d = q.shape
    extra = list(rows)
    for name, t in (("k", k), ("v", v), ("idx", idx), ("cnt", cnt),
                    *((f"input {i}", t) for i, t in enumerate(extra))):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    bf = [q, k, v] + [t for t in extra if t.dim() == 3]
    if not all(t.dtype == torch.bfloat16 for t in bf):
        raise TypeError(f"{what}: the CUDA kernel takes bf16 q/k/v/do (got "
                        f"{', '.join(str(t.dtype) for t in bf)})")
    stats = [t for t in extra if t.dim() == 2]
    if any(t.dtype != torch.float32 or t.shape != (BH, Sqp) for t in stats):
        raise TypeError(f"{what}: lse and delta must be f32 of shape {(BH, Sqp)}")
    if any(t.shape != q.shape for t in extra if t.dim() == 3):
        raise ValueError(f"{what}: do must have q's shape {tuple(q.shape)}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"{what}: schedule arrays must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, idx, cnt, *extra)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if d % 16 or d > 128:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 16 up to 128")
    for name, b in (("bq", bq), ("bk", bk)):
        if b % 16 or not 16 <= b <= 128:
            raise ValueError(f"{what}: {name}={b} must be a multiple of 16 in [16, 128]")
    if Sqp % bq or k.shape[1] % bk or k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"do not tile by (bq, bk) = {(bq, bk)}")
    if k.shape[0] * kv_groups != BH:
        raise ValueError(f"{what}: k has {k.shape[0]} rows, expected {BH} // {kv_groups}")
    if idx.dim() != 2 or idx.shape[0] != n_sched or cnt.shape != (n_sched,):
        raise ValueError(f"{what}: schedule has {idx.shape[0]} rows, expected {n_sched}")
    if any(t.data_ptr() % 16 for t in (q, k, v, *extra)):
        raise ValueError(f"{what}: q, k, v and do must be 16-byte aligned")


def _entry(name: str, n_ptr: int, n_int: int):
    lib = _build.load("flash_fwd" if name == "flash_fwd" else "flash_bwd")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _mask_args(q, k, idx, bq, bk, kv_groups, causal, window, q_offset, sk,
               scale, softcap):
    """The C entries' trailing (ints..., scale, softcap, stream) arguments."""
    BH, Sqp, d = q.shape
    return (BH, Sqp, k.shape[1], d, bq, bk, idx.shape[1], kv_groups,
            int(causal), int(window), int(q_offset), int(sk), float(scale),
            float(softcap), torch.cuda.current_stream(q.device).cuda_stream)


def _on_device(what, q):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_fwd(q, k, v, kv_idx, kv_cnt, *, bq: int, bk: int, causal: bool,
              window: int, q_offset: int, sk: int, scale: float,
              softcap: float, kv_groups: int):
    """K9 on the padded layout: q (BH, Sqp, d), k/v (BH/G, Skp, d), kv_idx
    (Sqp/bq, width) / kv_cnt (Sqp/bq,) int32 on q's device ->
    (o (BH, Sqp, d) q.dtype, lse (BH, Sqp) f32).  CUDA tensors run the
    kernel or raise; CPU tensors run the plain version."""
    global launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_fwd", q):
        return flash_attention_plain(q, k, v, kv_idx, kv_cnt, **kw)
    BH, Sqp, _ = q.shape
    _check_cuda("flash_fwd", q, k, v, kv_idx, kv_cnt, Sqp // bq, bq, bk, kv_groups)
    lib, fn = _entry("flash_fwd", 7, 12)
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sqp, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_idx.data_ptr(),
                kv_cnt.data_ptr(), o.data_ptr(), lse.data_ptr(),
                *_mask_args(q, k, kv_idx, **kw))
    _build.check(lib, rc, "flash_fwd launch")
    launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, kv_idx, kv_cnt, *, bq: int, bk: int,
             causal: bool, window: int, q_offset: int, sk: int, scale: float,
             softcap: float, kv_groups: int):
    """K10 on the padded layout: dq (BH, Sqp, d) in q.dtype, walking the
    forward schedule ``kv_idx``/``kv_cnt``.  do like q; lse and delta
    (BH, Sqp) f32.  CUDA tensors run the kernel or raise; CPU tensors run
    the plain version."""
    global dq_launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_dq", q):
        blocks = _schedule_mask(kv_idx, kv_cnt, k.shape[1] // bk, q.device)
        return flash_bwd_plain(q, k, v, do, lse, delta, blocks, **kw)[0]
    _check_cuda("flash_dq", q, k, v, kv_idx, kv_cnt, q.shape[1] // bq, bq, bk,
                kv_groups, rows=(do, lse, delta))
    lib, fn = _entry("flash_dq", 9, 12)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), kv_idx.data_ptr(),
                kv_cnt.data_ptr(), dq.data_ptr(), *_mask_args(q, k, kv_idx, **kw))
    _build.check(lib, rc, "flash_dq launch")
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, q_idx, q_cnt, *, bq: int, bk: int,
              causal: bool, window: int, q_offset: int, sk: int, scale: float,
              softcap: float, kv_groups: int):
    """K11 on the padded layout: (dk, dv) (BH/G, Skp, d) in k's dtype,
    walking the transposed schedule ``q_idx``/``q_cnt`` and summing each KV
    row's G query heads.  CUDA tensors run the kernel or raise; CPU tensors
    run the plain version."""
    global dkv_launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_dkv", q):
        blocks = _schedule_mask(q_idx, q_cnt, q.shape[1] // bq, q.device).T
        return flash_bwd_plain(q, k, v, do, lse, delta, blocks, **kw)[1:]
    _check_cuda("flash_dkv", q, k, v, q_idx, q_cnt, k.shape[1] // bk, bq, bk,
                kv_groups, rows=(do, lse, delta))
    lib, fn = _entry("flash_dkv", 10, 12)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), q_idx.data_ptr(),
                q_cnt.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_mask_args(q, k, q_idx, **kw))
    _build.check(lib, rc, "flash_dkv launch")
    dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, sched, **kw):
    """The backward of ``flash_fwd`` -> (dq, dk, dv): delta = rowsum(do * o)
    in f32 (plain torch, as the reference's jnp), then K10 on the forward
    schedule and K11 on the transposed one.  ``sched`` is
    (kv_idx, kv_cnt, q_idx, q_cnt).  On the CPU one plain pass gives all
    three."""
    kv_idx, kv_cnt, q_idx, q_cnt = sched
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    if not _on_device("flash_bwd", q):
        blocks = _schedule_mask(kv_idx, kv_cnt, k.shape[1] // kw["bk"], q.device)
        return flash_bwd_plain(q, k, v, do, lse, delta, blocks, **kw)
    dq = flash_dq(q, k, v, do, lse, delta, kv_idx, kv_cnt, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, q_idx, q_cnt, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the padded layout (the reference's
    ``_flash`` custom VJP): forward K9, saving o and lse (no recompute);
    backward ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, sched, kw):
        o, lse = flash_fwd(q, k, v, sched[0], sched[1], **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sched, ctx.kw = sched, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, o, lse, do, ctx.sched, **ctx.kw), None, None)


@functools.lru_cache(maxsize=256)
def _schedule_on(device, sq, sk, bq, bk, causal, window, q_offset):
    """(kv_idx, kv_cnt, q_idx, q_cnt) of ``sched_for(...)`` on ``device``,
    copied once: a host-to-device copy per call would synchronise the
    stream in every layer of every prefill and training step."""
    sched = sched_for(sq, sk, bq, bk, causal, window, q_offset)
    return tuple(torch.from_numpy(sched[n]).to(device)
                 for n in ("kv_idx", "kv_cnt", "q_idx", "q_cnt"))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128,
                    softcap: float = 0.0, kv_groups: int = 1,
                    return_lse: bool = False):
    """q: (BH, Sq, d); k, v: (BH/kv_groups, Sk, d) -> (BH, Sq, d)
    [, lse (BH, Sq) f32].  Differentiable (``FlashAttention``) unless
    ``return_lse``, which is forward only, as in the reference.

    Query row r sits at position ``Sk - Sq + r``, keys at their index;
    ``window`` masks keys at or below ``qpos - window``.  The AttnSchedule
    is a function of (Sq, Sk, bq, bk, causal, window, q_offset) alone, so
    the wrapper builds it from the shapes, memoized and copied to the
    device once per key (``_schedule_on``).  The reference's padded-grid
    baseline (``tight=False``) has no counterpart: the kernels loop over
    the live blocks, never over a padded width.  Non-aligned Sq/Sk are
    zero-padded to the blocks and trimmed after (autograd drops the padded
    rows' gradients); padded keys are masked.
    """
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    kv_groups = int(kv_groups)
    if BH % kv_groups or k.shape[0] != BH // kv_groups:
        raise ValueError(
            f"flash_attention: q has {BH} batch*head rows but k/v have "
            f"{k.shape[0]} with kv_groups={kv_groups}"
        )
    bq, bk = effective_blocks(Sq, Sk, bq, bk)
    Sqp, Skp = _round_up(Sq, bq), _round_up(Sk, bk)
    q_offset = Sk - Sq
    sched = _schedule_on(q.device, Sq, Sk, bq, bk, bool(causal), int(window),
                         q_offset)
    if Sqp != Sq:
        q = F.pad(q, (0, 0, 0, Sqp - Sq))
    if Skp != Sk:
        k = F.pad(k, (0, 0, 0, Skp - Sk))
        v = F.pad(v, (0, 0, 0, Skp - Sk))
    kw = dict(bq=bq, bk=bk, causal=bool(causal), window=int(window),
              q_offset=q_offset, sk=Sk, scale=float(1.0 / np.sqrt(d)),
              softcap=float(softcap), kv_groups=kv_groups)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if return_lse:
        o, lse = flash_fwd(q, k, v, sched[0], sched[1], **kw)
        return o[:, :Sq], lse[:, :Sq]
    return FlashAttention.apply(q, k, v, sched, kw)[:, :Sq]
