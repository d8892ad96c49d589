"""Flash attention on tight, schedule-driven KV walks, forward and backward.

Replaces three TPU kernels of ``repro/kernels/flash_attention.py`` with
hand-written CUDA kernels for Hopper (sm_90a); the designs are described in
the sources:

  K9  ``_fwd_kernel`` (``_fwd_call``)  o and the row logsumexp, walking
      ``kv_idx[qb, :kv_cnt[qb]]``              -> csrc/flash_fwd.cu
  K10 ``_dq_kernel`` (``_dq_call``)    dq on the same walk -> csrc/flash_bwd.cu
  K11 ``_dkv_kernel`` (``_dkv_call``)  dk and dv on the transposed walk
      ``q_idx[kb, :q_cnt[kb]]``, summed over each GQA group -> csrc/flash_bwd.cu
  K12 ``_paged_kernel`` (``_paged_call``)  the prefix phase of a suffix
      prefill: suffix queries over the live pages of a paged KV pool,
      through a block table, o and lse, the key walk split as
      ``paged_split_plan`` says and merged (``merge_partials_plain`` is the
      merge's plain version)                        -> csrc/flash_paged.cu

K9, K10, K11 and K12 share their warp-level core (mma.sync with
register-resident scores and accumulators, a two-stage cp.async ring):
csrc/flash_core.cuh.  K10 and K11 walk units of ``bwd_unit_rows`` rows
over tiles of ``bwd_tile_rows``, paired and split as ``bwd_plan`` says
from the schedule (``bwd_walks`` lists each CTA's walk as the kernels take
it; ``flash_bwd_walked_plain`` is the plain version that follows it).
K9-K11 take head_dim 256 (gemma3) in instantiations of their own; K12
stops at 128 (no path runs it at 256: gemma3's local layers refuse the
prefix cache).

The walks come from a host-built AttnSchedule (``core/attn_sched.py``); the
causal, sliding-window, ``q_offset`` and padded-key masks are applied in the
kernels, GQA is folded (q row b reads KV row b // G) and an optional
``c*tanh(s/c)`` softcap is applied (with its 1 - t^2 chain factor in the
backward).

Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at prefill and
training lengths the work is 4*d (forward), 6*d (dq) and 8*d (dk/dv) flops
per live (q, k) pair against q, k, v, o, do and the row statistics read
once, so the bound is usually the tensor cores.

``flash_fwd``, ``flash_dq``, ``flash_dkv`` and ``flash_attention_paged``
launch their kernels for CUDA tensors (bf16 only) and take the plain
versions (``flash_attention_plain``, ``flash_bwd_plain``,
``flash_attention_paged_plain``) only for CPU tensors.  ``launches``,
``dq_launches``, ``dkv_launches`` and ``paged_launches`` count kernel
launches.  ``flash_attention`` is the
public wrapper of the reference (``flash_attention.py:666``): block
clamping, padding to (bq, bk), the AttnSchedule of those shapes and the
``FlashAttention`` autograd Function (the reference's ``_flash`` custom VJP:
forward K9, backward delta = rowsum(do * o) in f32, then K10 and K11).
"""
from __future__ import annotations

import ctypes
import functools
import heapq

import numpy as np
import torch
import torch.nn.functional as F

from ..core.attn_sched import paged_prefix_schedule, sched_for
from . import _build
from .opaque import opaque

__all__ = [
    "FlashAttention",
    "effective_blocks",
    "flash_attention",
    "flash_attention_paged",
    "flash_attention_paged_plain",
    "flash_attention_plain",
    "bwd_ctas_per_sm",
    "bwd_plan",
    "bwd_tile_rows",
    "bwd_unit_rows",
    "bwd_walks",
    "bwd_warps",
    "flash_bwd",
    "flash_bwd_plain",
    "flash_bwd_walked_plain",
    "flash_dkv",
    "flash_dq",
    "flash_fwd",
    "grad_error_bound",
    "launch_info",
    "launches",
    "dq_launches",
    "dkv_launches",
    "merge_partials_plain",
    "paged_launches",
    "paged_split_plan",
    "o_error_bound",
]

NEG_INF = -1e30
EPS = 1e-30
PAGED_ROWS = 64    # folded query rows a K12 CTA takes (csrc/flash_paged.cu)
SPLIT_KEYS = 128   # the unit of a K12 split's key range
BWD_ROWS = 64      # rows of a K10 / K11 walk's tiles (K10's at d = 256: 32), and of a K11 unit
BWD_MAX_SPLIT = 4  # the most CTAs a K10 / K11 unit's walk is split over

# kernel launches since import (or since a caller reset them)
launches = 0      # K9
dq_launches = 0   # K10
dkv_launches = 0  # K11
paged_launches = 0  # K12


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


def bwd_unit_rows(kind: str, d: int) -> int:
    """Rows a K10 (``kind`` "dq": query rows) or K11 ("dkv": KV rows) unit
    owns at head_dim d: one 16-row warp each (a warp pair under K11 at
    d = 256), 8 warps for K10 at d = 64, 80 and 256, 4 otherwise
    (csrc/flash_bwd.cu; the card tests hold these to ``launch_info``)."""
    return 128 if kind == "dq" and d in (64, 80, 256) else BWD_ROWS


def bwd_tile_rows(kind: str, d: int) -> int:
    """Rows of the tiles a K10 (key rows) or K11 (query rows) unit walks:
    32 keys for K10 at d = 256 (its ring of two 64-key stages would leave
    no room for the unit's 128 Q and dO rows), else ``BWD_ROWS``."""
    return 32 if kind == "dq" and d == 256 else BWD_ROWS


def bwd_warps(kind: str, d: int) -> int:
    """Warps a K10 / K11 CTA runs: a 16-row warp a unit row group, two
    (a pair) for K11 at d = 256."""
    return bwd_unit_rows(kind, d) // 16 * (2 if kind == "dkv" and d == 256 else 1)


def bwd_ctas_per_sm(kind: str, d: int) -> int:
    """CTAs of K10 / K11 resident per SM at head_dim d: K10 2 (at d = 64
    and d = 80 by its 128-register launch bound, else by shared memory),
    K11 3 at d = 64 and d = 80 (its launch bound) and 2 at d = 128 and in
    the generic instantiation (shared memory); both 1 at d = 256 (shared
    memory), as csrc/flash_bwd.cu builds them and ``launch_info`` reads
    them on the card."""
    if d == 256:
        return 1
    return 3 if kind == "dkv" and d in (64, 80) else 2


def bwd_plan(kind: str, idx, cnt, *, bq: int, bk: int, causal: bool, window: int,
             q_offset: int, sk: int, groups: int, unit_rows: int, n_rows: int, slots: int,
             tile_rows: int = BWD_ROWS):
    """How K10 (``kind`` "dq") or K11 ("dkv") balance their walks on the
    schedule ``idx``/``cnt`` (numpy) -> (pair, n_split).

    ``pair`` puts unit j and unit n_units - 1 - j in one CTA, which walks
    both in turn (under a causal mask the walks grow linearly along the
    units, so every pair's walk is about as long); ``n_split`` splits each
    unit's walk of L steps into [s L // n_split, (s + 1) L // n_split), each
    split storing an f32 partial that the merge sums in order.  Each
    candidate, up to ``BWD_MAX_SPLIT`` splits, is scored by list scheduling its
    CTAs (``bwd_walks``, one per unit pair or unit and split, times
    ``n_rows`` grid rows, in launch order) onto ``slots`` resident CTAs
    (SMs times ``bwd_ctas_per_sm``), a CTA taking one step a tile plus one
    per unit; the shortest makespan wins, ties to fewer splits, then to no
    pairing.  chip_smoke.py times every candidate at its cases and says
    whether this pick was the fastest (``plans_ms``; PERF.md)."""
    best = None
    for n_split in range(1, BWD_MAX_SPLIT + 1):
        for pair in (False, True):
            walks = bwd_walks(kind, idx, cnt, bq=bq, bk=bk, causal=causal, window=window,
                              q_offset=q_offset, sk=sk, groups=groups, unit_rows=unit_rows,
                              pair=pair, n_split=n_split, tile_rows=tile_rows)
            dur = [sum(1 + len(steps) for _, _, steps in units) for _, units in walks]
            if len(dur) * n_rows <= slots:
                span = max(dur)
            else:
                free = [0] * slots  # a heap of the slots' finishing times
                for _ in range(n_rows):
                    for t in dur:
                        heapq.heapreplace(free, free[0] + t)
                span = max(free)
            if best is None or span < best[0]:
                best = (span, pair, n_split)
    return best[1], best[2]


def bwd_walks(kind: str, idx, cnt, *, bq: int, bk: int, causal: bool, window: int,
              q_offset: int, sk: int, groups: int, unit_rows: int, pair: bool, n_split: int,
              tile_rows: int = BWD_ROWS):
    """The walks of one grid row of K10 (``kind`` "dq", on the forward
    schedule ``idx``/``cnt``) or K11 ("dkv", on the transposed one), as the
    kernels take them -> one entry per CTA in blockIdx.x order:
    (split s, [(row0, rows, steps) for each unit the CTA walks]).

    A K10 unit is the query rows [row0, row0 + rows) (``unit_rows``,
    ``bwd_unit_rows``, or the rest of a q-block), a K11 unit the KV rows.
    Its candidate tiles are the ``tile_rows``-row sub-tiles
    (``bwd_tile_rows``) of its schedule's live blocks, in schedule order; a
    sub-tile
    wholly dead for the unit (every (q, k) pair masked by causality, the
    window or k >= sk) is dropped.  K10's steps are (0, key0, keys) per key
    tile; K11's are (member gm, q row0, rows) over the G members in turn.
    CTA c walks unit c and, when paired, unit n_units - 1 - c; split s of a
    unit's L steps takes [s L // n_split, (s + 1) L // n_split)."""
    idx, cnt = np.asarray(idx), np.asarray(cnt)
    blk, other = (bq, bk) if kind == "dq" else (bk, bq)
    parts = -(-blk // unit_rows)
    nsub = -(-other // tile_rows)
    n_units = idx.shape[0] * parts

    def unit(u, s):
        b, h = divmod(u, parts)
        row0 = b * blk + h * unit_rows
        rows = min(unit_rows, blk - h * unit_rows)
        tiles = []
        for step in range(int(cnt[b])):
            for sub in range(nsub):
                t0 = int(idx[b, step]) * other + sub * tile_rows
                n = min(tile_rows, other - sub * tile_rows)
                q0, nq, k0, nk = (row0, rows, t0, n) if kind == "dq" else (t0, n, row0, rows)
                q0 += q_offset
                dead = (k0 >= sk or (causal and k0 > q0 + nq - 1)
                        or (window and k0 + nk - 1 <= q0 - window))
                if not dead:
                    tiles.append((t0, n))
        steps = ([(0, t0, n) for t0, n in tiles] if kind == "dq"
                 else [(gm, t0, n) for gm in range(groups) for t0, n in tiles])
        L = len(steps)
        return row0, rows, steps[s * L // n_split:(s + 1) * L // n_split]

    n_c = -(-n_units // 2) if pair else n_units
    out = []
    for x in range(n_c * n_split):
        c, s = divmod(x, n_split)
        mates = [c] + ([n_units - 1 - c] if pair and n_units - 1 - c != c else [])
        out.append((s, [unit(u, s) for u in mates]))
    return out


def flash_bwd_walked_plain(q, k, v, do, lse, delta, dq_walks, dkv_walks, *,
                           n_split_dq: int, n_split_dkv: int, causal: bool,
                           window: int, q_offset: int, sk: int, scale: float,
                           softcap: float, kv_groups: int, **_):
    """K10 and K11's arithmetic on the CPU, tile by tile along ``bwd_walks``
    (the walks of every grid row) -> (dq, dk, dv): per step f32 scores and
    do @ v^T, p rounded to do's dtype and ds to q's, an f32 accumulator per
    unit, each split's partial summed in the order s = 0..n_split - 1 and
    rounded once.  The plain version that follows the kernels' plan (``bq``
    and ``bk`` are in the walks)."""
    BH, Sqp, d = q.shape
    G = kv_groups
    f = lambda t: t.float()

    def tile(qr, kr, vr, dor, l, dl, qpos, kpos):
        s = f(qr) @ f(kr).transpose(-1, -2) * scale
        t = None
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        ok = kpos[None, :] < sk
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        p = torch.where(ok, torch.exp(s - l[..., None]), 0.0)
        ds = p * (f(dor) @ f(vr).transpose(-1, -2) - dl[..., None]) * scale
        if t is not None:
            ds = ds * (1.0 - t * t)
        return p.to(do.dtype).float(), ds.to(q.dtype).float()

    dq = torch.zeros(n_split_dq, BH, Sqp, d)
    kv = torch.arange(BH) // G
    for s, units in dq_walks:
        for row0, rows, steps in units:
            r = slice(row0, row0 + rows)
            qpos = q_offset + torch.arange(row0, row0 + rows)
            for _, k0, n in steps:
                c = slice(k0, k0 + n)
                _, ds = tile(q[:, r], k[kv, c], v[kv, c], do[:, r], lse[:, r], delta[:, r],
                             qpos, torch.arange(k0, k0 + n))
                dq[s, :, r] += ds @ f(k[kv, c])
    BKV, Skp = k.shape[0], k.shape[1]
    dk, dv = torch.zeros(n_split_dkv, BKV, Skp, d), torch.zeros(n_split_dkv, BKV, Skp, d)
    heads = lambda t, gm: t.view(BKV, G, *t.shape[1:])[:, gm]
    for s, units in dkv_walks:
        for row0, rows, steps in units:
            c = slice(row0, row0 + rows)
            for gm, q0, n in steps:
                r = slice(q0, q0 + n)
                qr, dor = heads(q, gm)[:, r], heads(do, gm)[:, r]
                p, ds = tile(qr, k[:, c], v[:, c], dor, heads(lse, gm)[:, r],
                             heads(delta, gm)[:, r], q_offset + torch.arange(q0, q0 + n),
                             torch.arange(row0, row0 + rows))
                dk[s, :, c] += ds.transpose(1, 2) @ f(qr)
                dv[s, :, c] += p.transpose(1, 2) @ f(dor)

    def merged(part, like):
        out = part[0]
        for x in part[1:]:
            out = out + x
        return out.to(like.dtype)

    return merged(dq, q), merged(dk, k), merged(dv, v)


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
    if d % 16 or (d > 128 and d != 256):
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 16 up to 128, or 256")
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


def _entry(name: str, n_ptr: int, n_int: int, generic: bool = False, d: int = 0):
    if generic and d > 128:
        raise ValueError(f"{name}: the generic instantiation takes head_dim up to 128, "
                         f"not {d}")
    lib = _build.load("flash_fwd" if name == "flash_fwd" else "flash_bwd")
    fn = getattr(lib, name + ("_generic" if generic else ""))
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
              softcap: float, kv_groups: int, generic: bool = False):
    """K9 on the padded layout: q (BH, Sqp, d), k/v (BH/G, Skp, d), kv_idx
    (Sqp/bq, width) / kv_cnt (Sqp/bq,) int32 on q's device ->
    (o (BH, Sqp, d) q.dtype, lse (BH, Sqp) f32).  CUDA tensors run the
    kernel or raise; CPU tensors run the plain version.  ``generic`` runs
    the generic instantiation at any d (the yardstick of the d = 64, 80
    and 128 ones)."""
    global launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_fwd", q):
        return flash_attention_plain(q, k, v, kv_idx, kv_cnt, **kw)
    BH, Sqp, _ = q.shape
    _check_cuda("flash_fwd", q, k, v, kv_idx, kv_cnt, Sqp // bq, bq, bk, kv_groups)
    lib, fn = _entry("flash_fwd", 7, 12, generic, q.shape[2])
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sqp, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_idx.data_ptr(),
                kv_cnt.data_ptr(), o.data_ptr(), lse.data_ptr(),
                *_mask_args(q, k, kv_idx, **kw))
    _build.check(lib, rc, "flash_fwd launch")
    launches += 1
    return o, lse


@functools.lru_cache(maxsize=16)
def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _bwd_plan_for(kind, Sqp, Skp, d, n_rows, n_sm, bq, bk, causal, window, q_offset, sk,
                  kv_groups, **_):
    """``bwd_plan`` on the schedule ``flash_attention`` builds for these
    shapes (Sq = sk - q_offset), memoized; (False, 1) where the shapes are
    not such a schedule's.  The plan only orders the work: any plan gives
    the kernels' result (up to the order of f32 sums of a split).  d = 0
    plans for the generic instantiation's units and CTAs."""
    Sq = sk - q_offset
    if Sq < 1 or -(-Sq // bq) * bq != Sqp or -(-sk // bk) * bk != Skp:
        return False, 1
    sched = sched_for(Sq, sk, bq, bk, causal, window, q_offset)
    idx, cnt = ((sched["kv_idx"], sched["kv_cnt"]) if kind == "dq"
                else (sched["q_idx"], sched["q_cnt"]))
    return bwd_plan(kind, idx, cnt, bq=bq, bk=bk, causal=causal, window=window,
                    q_offset=q_offset, sk=sk, groups=kv_groups,
                    unit_rows=bwd_unit_rows(kind, d), n_rows=n_rows,
                    slots=n_sm * bwd_ctas_per_sm(kind, d), tile_rows=bwd_tile_rows(kind, d))


def _bwd_launch(kind, q, k, idx, kw, generic=False):
    """n_split of one K10 / K11 launch (its plan) and the C entry's
    trailing arguments."""
    BH, Sqp, d = q.shape
    pair, n_split = _bwd_plan_for(kind, Sqp, k.shape[1], 0 if generic else d,
                                  BH if kind == "dq" else k.shape[0], _n_sm(q.device), **kw)
    args = _mask_args(q, k, idx, **kw)
    return n_split, args[:12] + (int(pair), int(n_split)) + args[12:]


def flash_dq(q, k, v, do, lse, delta, kv_idx, kv_cnt, *, bq: int, bk: int,
             causal: bool, window: int, q_offset: int, sk: int, scale: float,
             softcap: float, kv_groups: int, generic: bool = False):
    """K10 on the padded layout: dq (BH, Sqp, d) in q.dtype, walking the
    forward schedule ``kv_idx``/``kv_cnt`` as ``bwd_plan`` balances it.  do
    like q; lse and delta (BH, Sqp) f32.  CUDA tensors run the kernel or
    raise; CPU tensors run the plain version.  ``generic``: as
    ``flash_fwd``'s."""
    global dq_launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_dq", q):
        blocks = _schedule_mask(kv_idx, kv_cnt, k.shape[1] // bk, q.device)
        return flash_bwd_plain(q, k, v, do, lse, delta, blocks, **kw)[0]
    _check_cuda("flash_dq", q, k, v, kv_idx, kv_cnt, q.shape[1] // bq, bq, bk,
                kv_groups, rows=(do, lse, delta))
    lib, fn = _entry("flash_dq", 10, 14, generic, q.shape[2])
    BH, Sqp, d = q.shape
    n_split, args = _bwd_launch("dq", q, k, kv_idx, kw, generic)
    dq = torch.empty_like(q)
    part = (torch.empty(n_split, BH, Sqp, d, dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), kv_idx.data_ptr(),
                kv_cnt.data_ptr(), dq.data_ptr(), part.data_ptr() if part is not None else 0,
                *args)
    _build.check(lib, rc, "flash_dq launch")
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, q_idx, q_cnt, *, bq: int, bk: int,
              causal: bool, window: int, q_offset: int, sk: int, scale: float,
              softcap: float, kv_groups: int, generic: bool = False):
    """K11 on the padded layout: (dk, dv) (BH/G, Skp, d) in k's dtype,
    walking the transposed schedule ``q_idx``/``q_cnt`` as ``bwd_plan``
    balances it and summing each KV row's G query heads.  CUDA tensors run
    the kernel or raise; CPU tensors run the plain version.  ``generic``:
    as ``flash_fwd``'s."""
    global dkv_launches
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=q_offset,
              sk=sk, scale=scale, softcap=softcap, kv_groups=kv_groups)
    if not _on_device("flash_dkv", q):
        blocks = _schedule_mask(q_idx, q_cnt, q.shape[1] // bq, q.device).T
        return flash_bwd_plain(q, k, v, do, lse, delta, blocks, **kw)[1:]
    _check_cuda("flash_dkv", q, k, v, q_idx, q_cnt, k.shape[1] // bk, bq, bk,
                kv_groups, rows=(do, lse, delta))
    lib, fn = _entry("flash_dkv", 12, 14, generic, q.shape[2])
    BKV, Skp, d = k.shape
    n_split, args = _bwd_launch("dkv", q, k, q_idx, kw, generic)
    dkv = torch.empty(2, BKV, Skp, d, dtype=k.dtype, device=k.device)
    part = (torch.empty(2, n_split, BKV, Skp, d, dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    parts = (part[0].data_ptr(), part[1].data_ptr()) if part is not None else (0, 0)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), q_idx.data_ptr(),
                q_cnt.data_ptr(), dkv[0].data_ptr(), dkv[1].data_ptr(), *parts, *args)
    _build.check(lib, rc, "flash_dkv launch")
    dkv_launches += 1
    return dkv[0], dkv[1]


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
    @opaque
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


def flash_attention_paged_plain(q, pool_k, pool_v, table, ctx, *,
                                softcap: float = 0.0):
    """Plain K12: the full masked softmax in f32 over the keys the table
    gathers.  Same arguments and outputs as ``flash_attention_paged``; key
    kpos of row b is live iff kpos < ctx[b] (the schedule's walk over all
    T pages, clipped by ctx); rows with no live key give o = 0 and
    lse = -1e30."""
    B, H, Sq, d = q.shape
    N, bs, KV, _ = pool_k.shape
    T = table.shape[1]
    G = H // KV
    walk = torch.as_tensor(paged_prefix_schedule(Sq, T, Sq, bs)["kv_idx"][0],
                           device=q.device).long()
    tab = table.long()[:, walk].clamp(0, N - 1)  # the sentinel N reads page N - 1
    live = torch.arange(T * bs, device=q.device)[None, :] < ctx.long()[:, None]
    scale = float(1.0 / np.sqrt(d))
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    for b in range(B):
        k = pool_k[tab[b]].reshape(T * bs, KV, d).float().permute(1, 2, 0)
        v = pool_v[tab[b]].reshape(T * bs, KV, d).float().transpose(0, 1)
        s = q[b].float().reshape(KV, G * Sq, d) @ k * scale  # (KV, G Sq, T bs)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~live[b], NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~live[b], 0.0)
        l = p.sum(-1, keepdim=True)
        o[b] = ((p @ v) / l.clamp_min(EPS)).reshape(H, Sq, d).to(q.dtype)
        lse[b] = torch.where(l > 0, m + torch.log(l.clamp_min(EPS)),
                             NEG_INF).reshape(H, Sq)
    return o, lse


def paged_split_plan(B: int, KV: int, R: int, T: int, bs: int, n_sm: int):
    """K12's split of the key walk, from shapes alone -> (n_split, ranges).

    The grid without a split is ceil(R / PAGED_ROWS) * B * KV CTAs (R = G * Sq
    folded rows of one KV head).  ``n_split`` is the smallest count that
    gives a grid of at least ``n_sm`` CTAs, capped by the number of
    SPLIT_KEYS-key tiles in the table's T * bs keys; split s covers the tiles
    [s * n // n_split, (s + 1) * n // n_split) of those n, so every tile lies
    in exactly one split, in order.  ``ranges`` lists each split's keys
    (k0, k1), k1 clipped to T * bs; the kernel computes the same ranges and
    clips them to the row's n_keys = min(ctx[b], T * bs) on the device."""
    n_keys = T * bs
    tiles = max(1, -(-n_keys // SPLIT_KEYS))
    base = B * KV * -(-R // PAGED_ROWS)
    n_split = min(tiles, -(-n_sm // base))
    ranges = [((s * tiles // n_split) * SPLIT_KEYS,
               min(((s + 1) * tiles // n_split) * SPLIT_KEYS, n_keys))
              for s in range(n_split)]
    return n_split, ranges


def merge_partials_plain(o_part, m_part, l_part):
    """Plain version of K12's merge of a split key walk: partials o_part
    (n_split, ..., d) f32 unnormalised, m_part and l_part (n_split, ...) f32
    (m = -1e30 where l = 0) -> (o (..., d) f32, lse (...) f32), in the
    kernel's fixed order s = 0..n_split-1: m* = max m_s,
    l = sum l_s e^(m_s - m*), o = sum o_s e^(m_s - m*) / max(l, 1e-30),
    lse = l > 0 ? m* + log l : -1e30."""
    m_all = m_part.amax(0)
    w = torch.exp(m_part - m_all)
    l = (l_part * w).sum(0)
    o = (o_part * w[..., None]).sum(0) / l.clamp_min(EPS)[..., None]
    lse = torch.where(l > 0, m_all + torch.log(l.clamp_min(EPS)),
                      torch.full_like(l, NEG_INF))
    return o, lse


def launch_info(kernel: str, d: int, width: int = 1, generic: bool = False) -> dict:
    """The launch a CUDA kernel gets at head_dim ``d`` (``kernel``
    "flash_fwd", "flash_dq" or "flash_dkv" at schedule width ``width``, or
    "flash_paged"): CTAs resident per SM, registers a thread, dynamic shared
    bytes, local (spill) bytes a thread and warps a CTA, from the CUDA
    runtime; ``generic``: the generic instantiation's (not K12's).  Needs a
    card."""
    lib = _build.load("flash_bwd" if kernel in ("flash_dq", "flash_dkv") else kernel)
    out = (ctypes.c_int * 5)()
    fn = getattr(lib, f"{kernel}_generic_info" if generic else f"{kernel}_info")
    if kernel == "flash_paged":
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        args = (d, ctypes.addressof(out))
    else:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        args = (d, width, ctypes.addressof(out))
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*args), f"{kernel} launch info")
    return dict(zip(("ctas_per_sm", "registers", "smem_bytes", "spill_bytes", "warps"),
                    list(out)))


def flash_attention_paged(q, pool_k, pool_v, table, ctx, *,
                          softcap: float = 0.0):
    """K12: suffix queries attending a paged KV prefix through a block
    table (the reference's ``flash_attention_paged``).

    q (B, H, Sq, d) roped suffix queries; pool_k/pool_v (N, bs, KV, d)
    (``models/attention.py::init_kv_pool``); table (B, T) int32 physical
    page ids (the sentinel N marks unowned entries); ctx (B,) int32 valid
    prefix lengths, on q's device.  Returns (o (B, H, Sq, d) in q's dtype,
    lse (B, H, Sq) f32); rows with ctx == 0 give o = 0 and lse = -1e30.
    CUDA tensors launch the kernel (bf16) or raise; CPU tensors run the
    plain version.  The reference's q-tile ``bq`` has no counterpart: the
    kernel tiles the G * Sq rows of each KV head by 64 and splits the key
    walk as ``paged_split_plan`` says (the split partials go to scratch
    allocated here; the same C call merges them).  Nothing here reads ctx or
    the table on the host.
    """
    global paged_launches
    if not _on_device("flash_attention_paged", q):
        return flash_attention_paged_plain(q, pool_k, pool_v, table, ctx,
                                           softcap=softcap)
    B, H, Sq, d = q.shape
    N, bs, KV, _ = pool_k.shape
    what = "flash_attention_paged"
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v), ("table", table),
                    ("ctx", ctx)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    if not all(t.dtype == torch.bfloat16 for t in (q, pool_k, pool_v)):
        raise TypeError(f"{what}: the CUDA kernel takes bf16 q and pools (got "
                        f"{q.dtype}, {pool_k.dtype}, {pool_v.dtype})")
    if table.dtype != torch.int32 or ctx.dtype != torch.int32:
        raise TypeError(f"{what}: table and ctx must be int32")
    if (pool_v.shape != pool_k.shape or pool_k.shape[3] != d or H % KV
            or table.dim() != 2 or table.shape[0] != B or ctx.shape != (B,)):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}, table {tuple(table.shape)}, "
                         f"ctx {tuple(ctx.shape)} do not match")
    if d % 16 or d > 128:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 16 up to 128 "
                         "(K12 has no head_dim 256 instantiation: no prefix-cache path "
                         "runs it)")
    if not all(t.is_contiguous() for t in (q, pool_k, pool_v, table, ctx)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError(f"{what}: q and the pools must be 16-byte aligned")
    lib = _build.load("flash_paged")
    fn = lib.flash_paged
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T = table.shape[1]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, _ = paged_split_plan(B, KV, (H // KV) * Sq, T, bs, n_sm)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    part = (0, 0, 0)
    if n_split > 1:
        rows = B * H * Sq
        o_part = torch.empty(n_split, rows, d, dtype=torch.float32, device=q.device)
        ml = torch.empty(2, n_split, rows, dtype=torch.float32, device=q.device)
        part = (o_part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                table.data_ptr(), ctx.data_ptr(), o.data_ptr(), lse.data_ptr(),
                *part, B, H, Sq, N, bs, KV, T, d, n_split,
                float(1.0 / np.sqrt(d)), float(softcap),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_paged launch")
    paged_launches += 1
    return o, lse
