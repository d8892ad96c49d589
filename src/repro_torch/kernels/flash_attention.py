"""Flash-attention forward on tight, schedule-driven KV walks.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_fwd_kernel``
(``pallas_call`` in ``_fwd_call``) with the hand-written CUDA kernel
``csrc/flash_fwd.cu`` for Hopper (sm_90a); the design is described there.
Per q-block the kernel walks exactly the live KV blocks of a host-built
AttnSchedule (``core/attn_sched.py``), with the causal, sliding-window,
``q_offset`` and padded-key masks applied in the kernel, GQA folded (q row b
reads KV row b // G) and an optional ``c*tanh(s/c)`` softcap.

Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at prefill lengths
the work is 4*d flops per live (q, k) pair and the bytes are q, k, v and o
once, so the bound is usually the tensor cores.

``flash_fwd`` launches the kernel for CUDA tensors (bf16 only) and takes the
plain version ``flash_attention_plain`` only for CPU tensors.  ``launches``
counts kernel launches.  ``flash_attention`` is the public wrapper of the
reference (``flash_attention.py:666``): block clamping, padding to
(bq, bk) and the AttnSchedule of those shapes.
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
    "effective_blocks",
    "flash_attention",
    "flash_attention_plain",
    "flash_fwd",
    "launches",
    "o_error_bound",
]

NEG_INF = -1e30
EPS = 1e-30

launches = 0  # kernel launches since import (or since a caller reset it)


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


def flash_attention_plain(q, k, v, kv_idx, kv_cnt, *, bq: int, bk: int,
                          causal: bool, window: int, q_offset: int, sk: int,
                          scale: float, softcap: float, kv_groups: int):
    """Plain version on the padded layout: the full masked softmax in f32.

    Same arguments and outputs as ``flash_fwd``.  A key is visible when the
    elementwise mask admits it AND its block is on the q-block's schedule;
    rows with no visible key give o = 0 and lse = +1e30.
    """
    BH, Sqp, d = q.shape
    Skp = k.shape[1]
    dev = q.device
    qpos = q_offset + torch.arange(Sqp, device=dev)[:, None]
    kpos = torch.arange(Skp, device=dev)[None, :]
    mask = kpos < sk
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    blocks = _schedule_mask(kv_idx, kv_cnt, Skp // bk, dev)
    mask = mask & blocks.repeat_interleave(bq, 0).repeat_interleave(bk, 1)
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sqp, dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 26) // (Sqp * Skp))  # bound the f32 score buffers
    for b0 in range(0, BH, chunk):
        rows = slice(b0, min(b0 + chunk, BH))
        kv = torch.arange(rows.start, rows.stop, device=dev) // kv_groups
        s = q[rows].float() @ k[kv].float().transpose(1, 2) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(-1, keepdim=True)
        o[rows] = ((p @ v[kv].float()) / l.clamp_min(EPS)).to(q.dtype)
        lse[rows] = torch.where(
            l > 0, m + torch.log(l.clamp_min(EPS)), -NEG_INF
        )[..., 0]
    return o, lse


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


def _check_cuda(q, k, v, kv_idx, kv_cnt, bq, bk, kv_groups):
    BH, Sqp, d = q.shape
    for name, t in (("k", k), ("v", v), ("kv_idx", kv_idx), ("kv_cnt", kv_cnt)):
        if t.device != q.device:
            raise ValueError(f"flash_fwd: {name} on {t.device}, q on {q.device}")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_fwd: the CUDA kernel takes bf16 q/k/v (got {q.dtype})")
    if kv_idx.dtype != torch.int32 or kv_cnt.dtype != torch.int32:
        raise TypeError("flash_fwd: kv_idx and kv_cnt must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, kv_idx, kv_cnt)):
        raise ValueError("flash_fwd: inputs must be contiguous")
    if d % 16 or d > 128:
        raise ValueError(f"flash_fwd: head_dim {d} must be a multiple of 16 up to 128")
    for name, b in (("bq", bq), ("bk", bk)):
        if b % 16 or not 16 <= b <= 128:
            raise ValueError(f"flash_fwd: {name}={b} must be a multiple of 16 in [16, 128]")
    if Sqp % bq or k.shape[1] % bk or k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"do not tile by (bq, bk) = {(bq, bk)}")
    if k.shape[0] * kv_groups != BH:
        raise ValueError(f"flash_fwd: k has {k.shape[0]} rows, expected {BH} // {kv_groups}")
    if kv_idx.shape[0] != Sqp // bq or kv_cnt.shape != (Sqp // bq,):
        raise ValueError("flash_fwd: schedule rows do not match Sqp / bq")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k and v must be 16-byte aligned")


def _launch(q, k, v, kv_idx, kv_cnt, bq, bk, causal, window, q_offset, sk,
            scale, softcap, kv_groups):
    global launches
    _check_cuda(q, k, v, kv_idx, kv_cnt, bq, bk, kv_groups)
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    BH, Sqp, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sqp, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_idx.data_ptr(),
                kv_cnt.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Sqp,
                k.shape[1], d, bq, bk, kv_idx.shape[1], kv_groups, int(causal),
                int(window), int(q_offset), int(sk), float(scale),
                float(softcap), stream)
    _build.check(lib, rc, "flash_fwd launch")
    launches += 1
    return o, lse


def flash_fwd(q, k, v, kv_idx, kv_cnt, *, bq: int, bk: int, causal: bool,
              window: int, q_offset: int, sk: int, scale: float,
              softcap: float, kv_groups: int):
    """Kernel entry on the padded layout: q (BH, Sqp, d), k/v (BH/G, Skp, d),
    kv_idx (Sqp/bq, width) / kv_cnt (Sqp/bq,) int32 on q's device ->
    (o (BH, Sqp, d) q.dtype, lse (BH, Sqp) f32).  CUDA tensors run the
    kernel or raise; CPU tensors run the plain version."""
    args = (q, k, v, kv_idx, kv_cnt)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if q.device.type == "cuda":
        return _launch(*args, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return flash_attention_plain(*args, **kw)


@functools.lru_cache(maxsize=256)
def _schedule_on(device, sq, sk, bq, bk, causal, window, q_offset):
    """(kv_idx, kv_cnt) of ``sched_for(...)`` on ``device``, copied once: a
    host-to-device copy per call would synchronise the stream in every
    layer of every prefill."""
    sched = sched_for(sq, sk, bq, bk, causal, window, q_offset)
    return (torch.from_numpy(sched["kv_idx"]).to(device),
            torch.from_numpy(sched["kv_cnt"]).to(device))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128,
                    softcap: float = 0.0, kv_groups: int = 1,
                    return_lse: bool = False):
    """q: (BH, Sq, d); k, v: (BH/kv_groups, Sk, d) -> (BH, Sq, d)
    [, lse (BH, Sq) f32].  Forward only.

    Query row r sits at position ``Sk - Sq + r``, keys at their index;
    ``window`` masks keys at or below ``qpos - window``.  The AttnSchedule
    is a function of (Sq, Sk, bq, bk, causal, window, q_offset) alone, so
    the wrapper builds it from the shapes, memoized and copied to the
    device once per key (``_schedule_on``).  The reference's padded-grid
    baseline (``tight=False``) has no counterpart: the kernel loops over
    ``kv_cnt`` live blocks, never over a padded width.  Non-aligned Sq/Sk
    are zero-padded to the blocks and trimmed after; padded keys are
    masked.
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
    kv_idx, kv_cnt = _schedule_on(q.device, Sq, Sk, bq, bk, bool(causal),
                                  int(window), q_offset)
    if Sqp != Sq:
        q = F.pad(q, (0, 0, 0, Sqp - Sq))
    if Skp != Sk:
        k = F.pad(k, (0, 0, 0, Skp - Sk))
        v = F.pad(v, (0, 0, 0, Skp - Sk))
    o, lse = flash_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), kv_idx, kv_cnt,
        bq=bq, bk=bk, causal=bool(causal), window=int(window),
        q_offset=q_offset, sk=Sk, scale=float(1.0 / np.sqrt(d)),
        softcap=float(softcap), kv_groups=kv_groups,
    )
    if return_lse:
        return o[:, :Sq], lse[:, :Sq]
    return o[:, :Sq]
