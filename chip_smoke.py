#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (src/repro_torch/) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  -- the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   -- nvcc builds every kernel from csrc/ into build/kernels/, one
                process per source, all at once
  3. parity  -- each kernel against its plain PyTorch version on the card, at
                the main paths' shapes, with the stated tolerance; each case
                timed with CUDA events (kernel, plain version, one PyTorch
                library call as a yardstick) beside its roofline bound:
                K1 (bf16, and f32 at the MLP shapes) and K9
  4. serve   -- serve h2o-danube-1.8b at full width and depth
                (block_sparse, block 128, flash_tight, ERK sparsity 0.8,
                seed 0): 8 staggered greedy requests x 32 tokens through
                ServeEngine; every request DONE, no quarantine, each kernel
                launched, and the kernel path's prefill and first decode
                logits within tolerance of the plain dense path on the same
                weights; then the decode step's device time (CUDA graph),
                the device time of its 168 K1 launches on the served packs,
                and K1 parity and timings on layer 0's ERK packs
  5. train   -- train h2o-danube-1.8b at full width and depth with RigL
                (block_sparse, flash_tight, ERK 0.8 in 128x128 blocks, Adam,
                warmup-cosine, batch 8 x 1024 in the config's 4 microbatches,
                6 steps, a drop/grow at step 2): first K2, K3 (on layer 0's
                packs and supersets) and K10, K11 against their plain
                versions and timed; the step-0 loss and two weight gradients
                against the plain dense path on the same weights; then
                ``train_loop``: finite losses, the exact launch counts of
                every kernel per step, and after the update unchanged block
                counts, a valid, fresh pack and B ⊇ A; wall and device time
                per step, tokens per second, peak memory
  6. report  -- one JSON line of per-kernel numbers, the card line, and last
                {"ok": true, "device": {...}}

Per-case details also go to chiprun_out/chip_smoke.json.  Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12  # f32 outside the tensor cores (the f32 kernels' FFMA)
L2_BYTES = 50 * 2**20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_BF16_FLOP_S):
    """(least time in ms, "bytes" or "operations"): bytes over the memory
    rate against operations over ``peak`` (the operands' type's rate)."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def peak_of(torch, dtype) -> float:
    return PEAK_F32_FLOP_S if dtype == torch.float32 else PEAK_BF16_FLOP_S


class Timer:
    """Device time of one call by CUDA events, L2 flushed before each
    repetition (the main path reads every layer's weights cold).  A spin
    kernel ahead of the first event keeps the card busy while the host
    enqueues the call, so the events measure the call's device work and not
    the host's launch overhead."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / reps


def k1_case(torch, timer, bsm, label, x, w, idx, cnt, blk):
    """K1 on one input against its plain version, timed beside its bound.
    The weights are zero outside their active blocks, as the served weights
    are, so the library yardstick x @ w computes the same function."""
    from repro_torch.kernels.ops import _row_tile, block_sparse_linear

    M, K = x.shape
    N = w.shape[1]
    bm, Mp = _row_tile(M, 128)
    y = block_sparse_linear(x, w, pack=(idx, cnt), block=(128, blk, blk))
    xp = torch.nn.functional.pad(x, (0, 0, 0, Mp - M))
    ref = bsm.block_sparse_matmul_plain(xp, w, idx, cnt, blk, blk)[:M]
    err = (y.float() - ref.float()).abs().max().item()
    if x.dtype == torch.bfloat16:
        # both accumulate in f32 and round once to bf16: one bf16 ulp of
        # the largest output at most
        tol = 2.0**-7 * ref.float().abs().max().item()
        ok, ratio = err <= tol, err / max(tol, 1e-30)
    else:  # f32 element by element (bsm.matmul_error_bound)
        absp = bsm.block_sparse_matmul_plain(xp.abs(), w.abs(), idx, cnt, blk, blk)[:M]
        ok, ratio, tol = within(torch, y, ref, bsm.matmul_error_bound(ref, absp, K))
    if not ok:
        raise AssertionError(f"K1 {label}: err {err} exceeds its bound ({ratio:.3g}x)")
    # the served function's bytes and flops: its M rows, not the padded Mp
    nnz = int(cnt.sum())
    es = x.element_size()
    b_ms, by = bound_ms(
        es * (M * K + nnz * blk * blk + M * N) + 4 * (idx.numel() + cnt.numel()),
        2.0 * M * nnz * blk * blk, peak_of(torch, x.dtype),
    )
    case = {
        "case": f"{label} {str(x.dtype)[6:]} M={M}->{Mp} K={K} N={N} "
                f"blocks={nnz}/{K // blk * N // blk}",
        "max_abs_err": err, "tol": tol, "err_over_tol": ratio,
        "ms": timer(lambda: bsm.block_sparse_matmul(xp, w, idx, cnt, bm=bm, bn=blk, bk=blk)),
        "plain_ms": timer(lambda: bsm.block_sparse_matmul_plain(xp, w, idx, cnt, blk, blk), reps=5),
        "library_ms": timer(lambda: x @ w),
        "bound_ms": b_ms, "bound_by": by,
    }
    print("K1", json.dumps(case))
    return case, y


def within(torch, got, want, bound):
    """(every element within its bound, worst err/bound, mean bound)."""
    diff = (got.float() - want.float()).abs()
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    return bool((diff <= bound).all()), ratio, bound.float().mean().item()


def uniform_blocks(rng, K, N, blk, density=0.2):
    """A random block mask at ``density`` with column 1 empty."""
    import numpy as np

    nkb, nnb = K // blk, N // blk
    bm = np.zeros(nkb * nnb, bool)
    bm[rng.choice(nkb * nnb, round(density * nkb * nnb), replace=False)] = True
    bm = bm.reshape(nkb, nnb)
    bm[:, 1] = False  # an all-empty column must come out as zeros
    return bm


def k1_cases(torch, timer, bsm, pack_np):
    """K1 at the main paths' shapes: decode (4 rows -> 16) and prefill (512
    rows) over each danube projection shape in bf16, and decode (4 -> 16)
    and prefill (1024) at the MLP shapes in f32 (the MLP runs in the f32
    residual's dtype), 80% block sparsity, one empty column."""
    import numpy as np

    rng = np.random.default_rng(0)
    blk = 128
    out = []
    for K, N, dt, rows in ((2560, 2560, torch.bfloat16, (4, 512)),
                           (2560, 640, torch.bfloat16, (4, 512)),
                           (2560, 6912, torch.bfloat16, (4, 512)),
                           (6912, 2560, torch.bfloat16, (4, 512)),
                           (2560, 6912, torch.float32, (4, 1024)),
                           (6912, 2560, torch.float32, (4, 1024))):
        bm = uniform_blocks(rng, K, N, blk)
        dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 0), blk, 1)).cuda()
        w = (torch.randn(K, N, device="cuda") / K**0.5 * dense).to(dt)
        idx, cnt = (torch.from_numpy(a).cuda() for a in pack_np(bm))
        for M in rows:
            x = torch.randn(M, K, device="cuda").to(dt)
            case, y = k1_case(torch, timer, bsm, "uniform 20%", x, w, idx, cnt, blk)
            if y[:, blk:2 * blk].abs().max().item() != 0:
                raise AssertionError(f"K1 {case['case']}: the empty column is not zero")
            out.append(case)
    return out


def packed_projections(engine, layer):
    """(name, w, pack entry) of every block-sparse projection of a layer."""
    for sub in ("attn", "mlp"):
        for name, leaf in engine.pack["layers"][layer][sub].items():
            if leaf["w"] is not None:
                yield (f"{sub}.{name}", engine.params["layers"][layer][sub][name]["w"],
                       leaf["w"])


def k1_served_cases(torch, timer, bsm, engine):
    """K1 on the served model's own ERK packs (layer 0: every projection
    shape at its ERK density; bf16 attention, f32 MLP as served), at a
    decode step's 4 rows and at the 1024 rows of the longest prompt
    bucket."""
    blk = engine.cfg.sparse.kernel_block[2]
    out = []
    for name, w, e in packed_projections(engine, 0):
        for M in (4, 1024):
            x = torch.randn(M, w.shape[0], device="cuda").to(w.dtype)
            out.append(k1_case(torch, timer, bsm, f"served layer0 {name}", x, w,
                               e["idx"], e["cnt"], blk)[0])
    return out


def k1_decode_ms(torch, bsm, engine):
    """Device time of every K1 launch of one capacity-4 decode step, on the
    served weights and packs of all layers: the launches are captured once
    in a CUDA graph and replayed back to back, as the decode step's graph
    replays them (``decode_device_ms``)."""
    blk = engine.cfg.sparse.kernel_block[2]
    calls = []
    for layer in range(engine.cfg.n_layers):
        for _, w, e in packed_projections(engine, layer):
            x = torch.randn(16, w.shape[0], device="cuda").to(w.dtype)
            calls.append((x, w, e["idx"], e["cnt"]))
    run = lambda: [bsm.block_sparse_matmul(*c, bm=16, bn=blk, bk=blk) for c in calls]
    return graph_ms(torch, run), len(calls)


def graph_ms(torch, fn):
    """Device time of ``fn`` replayed from a CUDA graph (no host work between
    its kernels), by CUDA events around the second replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def k9_cases(torch, timer, fa, sched_for):
    """K9 at danube's attention shapes: 32 query heads over 8 KV heads
    (G = 4), head_dim 80, bf16.  The yardstick is PyTorch's
    scaled_dot_product_attention with the same boolean mask (none for the
    softcap case: that call has no softcap)."""
    F = torch.nn.functional
    BH, G, d = 32, 4, 80
    cases = (  # (name, S, window, softcap)
        ("S=512 causal", 512, 0, 0.0),
        ("S=1024 window=4096 (main-path bucket)", 1024, 4096, 0.0),
        ("S=6144 window=4096", 6144, 4096, 0.0),
        ("S=300 ragged causal", 300, 0, 0.0),
        ("S=512 causal softcap=30", 512, 0, 30.0),
    )
    out = []
    for name, S, window, softcap in cases:
        q = torch.randn(BH, S, d, device="cuda").to(torch.bfloat16)
        k = torch.randn(BH // G, S, d, device="cuda").to(torch.bfloat16)
        v = torch.randn(BH // G, S, d, device="cuda").to(torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=softcap, kv_groups=G,
                  return_lse=True)
        o, lse = fa.flash_attention(q, k, v, **kw)
        # the plain version at the kernel's blocks and schedule, on the card
        bq, bk = fa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        sched = sched_for(S, S, bq, bk, True, window, 0)
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        pargs = (pad(q), pad(k), pad(v),
                 torch.from_numpy(sched["kv_idx"]).cuda(),
                 torch.from_numpy(sched["kv_cnt"]).cuda())
        pkw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                   scale=d**-0.5, softcap=softcap, kv_groups=G)
        po, plse = fa.flash_attention_plain(*pargs, **pkw)
        pa, _ = fa.flash_attention_plain(pargs[0], pargs[1], pargs[2].abs(),
                                         *pargs[3:], **pkw)
        po, pa, plse = po[:, :S], pa[:, :S], plse[:, :S]
        # o, element by element: the bound of rounding p to bf16 in the
        # kernel and o to bf16 on both sides (fa.o_error_bound); lse: f32 in
        # both
        diff = (o.float() - po.float()).abs()
        bound = fa.o_error_bound(po, pa)
        err_o, err_l = diff.max().item(), (lse - plse).abs().max().item()
        ratio = (diff / bound.clamp_min(1e-30)).max().item()
        if not (bool((diff <= bound).all()) and err_l <= 1e-3):
            raise AssertionError(f"K9 {name}: o exceeds its per-element bound "
                                 f"{ratio:.3g}-fold (max err {err_o}), lse err {err_l}")
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        live = int(mask.sum())
        b_ms, by = bound_ms(2 * (2 * BH * S * d + 2 * (BH // G) * S * d) + 4 * BH * S,
                            4.0 * d * live * BH)
        lib_ms = None
        if not softcap:
            q4, k4, v4 = (t.view(1, -1, S, d) for t in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), reps=5)
        case = {
            "case": f"{name} BH={BH} G={G} d={d}",
            "max_abs_err": err_o, "lse_err": err_l, "lse_tol": 1e-3,
            "tol": "2**-7 |o| + 1.25 * 2**-8 (p @ |v|) / l, per element",
            "err_over_tol": ratio, "mean_abs_o": po.float().abs().mean().item(),
            "mean_tol": bound.mean().item(),
            "ms": timer(lambda: fa.flash_fwd(*pargs, **pkw), reps=5),
            "plain_ms": timer(lambda: fa.flash_attention_plain(*pargs, **pkw),
                              reps=2, warmup=1),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
        }
        print("K9", json.dumps(case))
        out.append(case)
    return out


def main_path(torch, timer, bsm, fa):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (
        configure_kernel,
        init_serving_state,
        staggered_requests,
    )
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    engine = ServeEngine(cfg, params, capacity=4, max_len=2048, masks=masks,
                         pack=pack)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"main: full h2o-danube-1.8b ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) initialised in {init_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    # warm-up (cuBLAS handles, allocator), before the counted run
    for r in staggered_requests(cfg, 2, prompt_lens=(100,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()

    reqs = staggered_requests(cfg, 8, prompt_lens=(100, 300, 1000),
                              gen_lens=(32,), seed=0)
    engine = ServeEngine(cfg, engine.params, capacity=4, max_len=2048,
                         masks=masks, pack=pack)
    for r in reqs:
        engine.submit(r)
    bsm.launches = 0
    fa.launches = 0
    stats = engine.run()
    launches = {"block_sparse_fwd": bsm.launches, "flash_fwd": fa.launches}
    print("main: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "quarantined",
        "failed", "wall_s", "tok_per_s", "prefill_s", "decode_step_s")}))
    print(f"main: prefill {1e3 * stats['prefill_s'] / stats['prefills']:.2f} "
          f"ms/request, decode {1e3 * stats['decode_step_s']:.2f} ms/step "
          f"(capacity 4), {stats['tok_per_s']:.2f} tok/s end to end; "
          f"launches {launches}")
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != 32:
            raise AssertionError(f"request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"quarantined/failed slots: {stats}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # the kernel path against the plain dense path on the same weights: a
    # prompt's prefill logits and one decode step
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    toks = torch.from_numpy(reqs[0].tokens).long().cuda()[None]
    res = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        logits, caches = lm_prefill(engine.params, c, {"tokens": toks}, 128,
                                    masks=masks, pack=pack)
        nxt = logits[:, -1].argmax(-1)[:, None]
        step, _ = lm_decode(engine.params, c, caches, nxt, toks.shape[1],
                            masks=masks, pack=pack)
        V = cfg.vocab_size
        res[name] = (logits.float()[..., :V], step.float()[..., :V])
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["kernel"][i], res["dense"][i]
        if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, cfg.vocab_size):
            raise AssertionError(f"{what} logits not finite or of the wrong shape")
        err = (a - b).abs().max().item()
        tol = 2e-2 * b.abs().max().item()
        top_a, top_b = a.flatten().topk(2), b.flatten().topk(2)
        gap = (top_b.values[0] - top_b.values[1]).item()
        print(f"main: {what} logits, kernel path vs dense path: max err "
              f"{err:.4g} (tol {tol:.4g}); top-1 {int(top_a.indices[0])} vs "
              f"{int(top_b.indices[0])}, the dense path's top two "
              f"{top_b.indices.tolist()} {gap:.4g} apart, the kernel path's "
              f"{top_a.indices.tolist()} {(top_a.values[0] - top_a.values[1]).item():.4g} apart")
        stats[f"{what}_top2_gap_dense"] = gap
        if err > tol:
            raise AssertionError(f"{what} logits differ from the dense path")
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode)
    k1_ms, n_calls = k1_decode_ms(torch, bsm, engine)
    stats["k1_decode_step_ms"] = k1_ms
    print(f"main: K1 in one decode step: {n_calls} launches on the served "
          f"packs, {k1_ms:.2f} ms device time (CUDA-graph replay), "
          f"{k1_ms / stats['decode_step_device_ms']:.1%} of the step's device time")
    served = k1_served_cases(torch, timer, bsm, engine)
    return stats, launches, served


def decode_device_ms(torch, engine, lm_decode):
    """Device time of one full-capacity decode step against its host-clock
    time.  The step is captured once in a CUDA graph; a replay runs the same
    kernels back to back with no host work between them, so the events
    around it time the step's device work alone.  Runs after the served
    requests: it only rewrites cache slots past their end."""
    dev = engine.device
    tok = torch.from_numpy(engine.cur_tok[:, None]).to(dev)
    pos = torch.from_numpy(engine.pos).to(dev)
    step = lambda: lm_decode(engine.params, engine.cfg, engine.caches, tok, pos,
                             masks=engine.masks, pack=engine.pack)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_ms = graph_ms(torch, step)
    print(f"main: decode step at capacity 4: {dev_ms:.2f} ms device time "
          f"(CUDA-graph replay), {wall_ms:.2f} ms host clock, card idle "
          f"{1 - dev_ms / wall_ms:.1%} of the host-driven step")
    return dev_ms


def bs_bwd_cases(torch, timer, bsm, pack_np, state, cfg):
    """K2 (dx on the CSR) and K3 (dw on the Top-KAST superset CSC) on the
    training path's own packs: layer 0's seven projections at M = 2048 rows
    (one microbatch of 2 x 1024), bf16 for attention and f32 for the MLP as
    the path runs them; plus a uniform-20% bf16 case with an empty column
    and a 10% superset.  Each output element by element within
    ``bsm.matmul_error_bound``."""
    import numpy as np

    blk, M = cfg.sparse.kernel_block[2], 2048
    items = []
    for sub in ("attn", "mlp"):
        dt = torch.bfloat16 if sub == "attn" else torch.float32
        for name, leaf in state["pack"]["layers"][0][sub].items():
            w = state["params"]["layers"][0][sub][name]["w"].to(dt)
            items.append((f"train layer0 {sub}.{name}", w, leaf["w"]))
    rng = np.random.default_rng(1)
    bm = uniform_blocks(rng, 2560, 2560, blk)
    sup = bm | (rng.random(bm.shape) < 0.1)
    dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 0), blk, 1)).cuda()
    w = (torch.randn(2560, 2560, device="cuda") / 2560**0.5 * dense).to(torch.bfloat16)
    t = lambda a: torch.from_numpy(a).cuda()
    (ridx, rcnt), (bidx, bcnt) = pack_np(bm.T), pack_np(sup)
    items.append(("uniform 20% + 10% superset", w,
                  {"ridx": t(ridx), "rcnt": t(rcnt), "bidx": t(bidx), "bcnt": t(bcnt)}))
    k2, k3 = [], []
    for label, w, e in items:
        K, N = w.shape
        dt, es, peak = w.dtype, w.element_size(), peak_of(torch, w.dtype)
        x = torch.randn(M, K, device="cuda").to(dt)
        g = torch.randn(M, N, device="cuda").to(dt)
        ridx, rcnt, bidx, bcnt = e["ridx"], e["rcnt"], e["bidx"], e["bcnt"]
        dx = bsm.block_sparse_dx(g, w, ridx, rcnt, bm=128, bn=blk, bk=blk)
        want = bsm.block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk)
        absp = bsm.block_sparse_dx_plain(g.abs().float(), w.abs().float(), ridx, rcnt, blk, blk)
        ok, ratio, tol = within(torch, dx, want, bsm.matmul_error_bound(want, absp, N))
        if not ok:
            raise AssertionError(f"K2 {label}: exceeds its bound ({ratio:.3g}x)")
        nnz, bnnz = int(rcnt.sum()), int(bcnt.sum())
        b_ms, by = bound_ms(es * (M * N + nnz * blk * blk + M * K)
                            + 4 * (ridx.numel() + rcnt.numel()),
                            2.0 * M * nnz * blk * blk, peak)
        case = {"case": f"{label} {str(dt)[6:]} M={M} K={K} N={N} blocks={nnz}/"
                        f"{K // blk * N // blk}",
                "max_abs_err": (dx.float() - want.float()).abs().max().item(),
                "err_over_tol": ratio, "mean_tol": tol,
                "ms": timer(lambda: bsm.block_sparse_dx(g, w, ridx, rcnt, bm=128, bn=blk, bk=blk)),
                "plain_ms": timer(lambda: bsm.block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk), reps=3),
                "library_ms": timer(lambda: g @ w.T), "bound_ms": b_ms, "bound_by": by}
        print("K2", json.dumps(case))
        k2.append(case)
        dw = bsm.block_sparse_dw(x, g, bidx, bcnt, bn=blk, bk=blk)
        want = bsm.block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk)
        absp = bsm.block_sparse_dw_plain(x.abs().float(), g.abs().float(), bidx, bcnt, blk, blk)
        ok, ratio, tol = within(torch, dw, want, bsm.matmul_error_bound(want, absp, M))
        if not ok:
            raise AssertionError(f"K3 {label}: exceeds its bound ({ratio:.3g}x)")
        # the function's output is the dense (K, N) dw: written once
        b_ms, by = bound_ms(es * (M * K + M * N + K * N) + 4 * (bidx.numel() + bcnt.numel()),
                            2.0 * M * bnnz * blk * blk, peak)
        case = {"case": f"{label} {str(dt)[6:]} M={M} K={K} N={N} superset blocks="
                        f"{bnnz}/{K // blk * N // blk}",
                "max_abs_err": (dw.float() - want.float()).abs().max().item(),
                "err_over_tol": ratio, "mean_tol": tol,
                "ms": timer(lambda: bsm.block_sparse_dw(x, g, bidx, bcnt, bn=blk, bk=blk)),
                "plain_ms": timer(lambda: bsm.block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk), reps=3),
                "library_ms": timer(lambda: x.T @ g), "bound_ms": b_ms, "bound_by": by}
        print("K3", json.dumps(case))
        k3.append(case)
    return k2, k3


def flash_bwd_cases(torch, timer, fa):
    """K10 (dq) and K11 (dk, dv) at danube's attention shapes (32 query
    heads per sequence over 8 KV heads, G = 4, head_dim 80, bf16): the
    training microbatch's S = 1024 under the window 4096 (BH = 64), a 256
    window at S = 512, a ragged causal S = 300, and a softcap-30 case
    (parity only: PyTorch's attention has no softcap).  Each gradient
    element by element within ``fa.grad_error_bound``; the yardstick is the
    backward of scaled_dot_product_attention with the same mask and
    enable_gqa, which computes dq, dk and dv together (timed as a pair)."""
    F = torch.nn.functional
    G, d = 4, 80
    cases = (("S=1024 window=4096 (main-path shape)", 64, 1024, 4096, 0.0),
             ("S=512 window=256", 32, 512, 256, 0.0),
             ("S=300 ragged causal", 32, 300, 0, 0.0),
             ("S=512 causal softcap=30 (parity only)", 32, 512, 0, 30.0))
    k10, k11 = [], []
    for name, BH, S, window, softcap in cases:
        r = lambda n: torch.randn(n, S, d, device="cuda").to(torch.bfloat16)
        q, k, v, do = r(BH), r(BH // G), r(BH // G), r(BH)
        bq, bk = fa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        qp, kp, vp, dop = pad(q), pad(k), pad(v), pad(do)
        sched = fa._schedule_on(q.device, S, S, bq, bk, True, window, 0)
        kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                  scale=d**-0.5, softcap=softcap, kv_groups=G)
        o, lse = fa.flash_fwd(qp, kp, vp, sched[0], sched[1], **kw)
        delta = (dop.float() * o.float()).sum(-1)
        dq_args = (qp, kp, vp, dop, lse, delta, sched[0], sched[1])
        dkv_args = (qp, kp, vp, dop, lse, delta, sched[2], sched[3])
        dq = fa.flash_dq(*dq_args, **kw)
        dk, dv = fa.flash_dkv(*dkv_args, **kw)
        blocks = fa._schedule_mask(sched[0], sched[1], Sp // bk, q.device)
        plain_args = (qp, kp, vp, dop, lse, delta, blocks)
        want_q, want_k, want_v, rq, rk, rv, eq, ek, ev = fa.flash_bwd_plain(
            *plain_args, with_abs=True, **kw)
        checks = {}
        for what, got, want, rnd, err in (("dq", dq, want_q, rq, eq), ("dk", dk, want_k, rk, ek),
                                          ("dv", dv, want_v, rv, ev)):
            ok, ratio, tol = within(torch, got, want, fa.grad_error_bound(want, rnd, err))
            if not ok:
                raise AssertionError(f"K10/K11 {name} {what}: exceeds its bound ({ratio:.3g}x)")
            checks[what] = ((got.float() - want.float()).abs().max().item(), ratio, tol)
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        live = int(mask.sum())
        lib_ms = None
        if not softcap:
            q4, k4, v4 = (t.view(1, -1, S, d).detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
            do4 = do.view(1, BH, S, d)
            lib_ms = timer(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                                       retain_graph=True), reps=5)
        plain_ms = timer(lambda: fa.flash_bwd_plain(*plain_args, **kw), reps=2, warmup=1)
        BKV = BH // G
        for kernel, fn, args, what, n_bytes, flops in (
                ("K10", fa.flash_dq, dq_args, ("dq",),
                 2 * (3 * BH * S * d + 2 * BKV * S * d) + 8 * BH * S, 6.0 * d * live * BH),
                ("K11", fa.flash_dkv, dkv_args, ("dk", "dv"),
                 2 * (2 * BH * S * d + 4 * BKV * S * d) + 8 * BH * S, 8.0 * d * live * BH)):
            b_ms, by = bound_ms(n_bytes, flops)
            case = {"case": f"{name} BH={BH} G={G} d={d}",
                    "max_abs_err": max(checks[w_][0] for w_ in what),
                    "err_over_tol": max(checks[w_][1] for w_ in what),
                    "mean_tol": {w_: checks[w_][2] for w_ in what},
                    "ms": timer(lambda: fn(*args, **kw), reps=5),
                    "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
                    "library_ms": lib_ms, "library_covers": "dq, dk and dv",
                    "bound_ms": b_ms, "bound_by": by}
            print(kernel, json.dumps(case))
            (k10 if kernel == "K10" else k11).append(case)
    return k10, k11


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, DELTA_T = 6, 8, 1024, 2


def train_config():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    return dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, method="rigl", delta_t=DELTA_T))


def train_dense_check(torch, cfg, state):
    """The step-0 loss of one microbatch (2 x 1024) and the gradients of an
    MLP and an attention weight of layer 0, on the kernel path, against the
    plain dense path on the same weights (masked dense matmuls, the plain
    masked softmax).  The kernel path's weight gradient is the dense one
    restricted to the superset B, and exactly zero outside it."""
    from repro_torch.core.masks import apply_masks, tree_map, tree_paths
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.model import lm_loss

    names = ("layers/0/mlp/wi/w", "layers/0/attn/wq/w")
    b = batch_for(cfg, 0, 2, TRAIN_SEQ, learnable=True, device="cuda")
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))

    def loss_and_grads(c, params, **kw):
        leaves = {}

        def pick(n, t):
            if n in names:
                t = leaves[n] = t.detach().requires_grad_(True)
            return t

        loss = lm_loss(tree_map(pick, params), c, b, **kw)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.item(), dict(zip(names, grads))

    lk, gk = loss_and_grads(cfg, state["params"], masks=state["masks"], pack=state["pack"])
    ld, gd = loss_and_grads(dense, apply_masks(state["params"], state["masks"]))
    bwd = tree_paths(state["bwd_masks"])
    out = {"loss_kernel": lk, "loss_dense": ld, "loss_rel_err": abs(lk - ld) / abs(ld)}
    # tolerances: both paths run attention in bf16 and round at other
    # points (flash's p vs the softmax weights, in another order), so the
    # loss moves by ~1e-4 relative and a weight gradient, a sum over 2048
    # rows of products of such activations, by up to ~1% in norm
    if not out["loss_rel_err"] <= 1e-3:
        raise AssertionError(f"step-0 loss: kernel {lk} vs dense {ld}")
    for n in names:
        ref = gd[n] * bwd[n]
        rel = ((gk[n] - ref).norm() / ref.norm()).item()
        outside = gk[n][~bwd[n]].abs().max().item() if (~bwd[n]).any() else 0.0
        out[f"{n} grad_rel_err"] = rel
        if not (rel <= 2e-2 and outside == 0.0):
            raise AssertionError(f"step-0 gradient of {n}: rel err {rel}, "
                                 f"{outside} outside the superset")
    print("train: step 0, kernel path vs dense path:", json.dumps(out))
    return out


def train_path(torch, bsm, fa, cfg):
    """``train_loop`` at full width and depth, with the launch counters set
    to 0 just before it and read after every step."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_mismatch, validate_pack
    from repro_torch.launch.train import train_loop

    counters = (("block_sparse_fwd", bsm, "launches"), ("block_sparse_dx", bsm, "dx_launches"),
                ("block_sparse_dw", bsm, "dw_launches"), ("flash_fwd", fa, "launches"),
                ("flash_dq", fa, "dq_launches"), ("flash_dkv", fa, "dkv_launches"))
    read = lambda: {n: getattr(mod, a) for n, mod, a in counters}
    mb, n_proj, n_attn = cfg.microbatches, 7 * cfg.n_layers, cfg.n_layers
    # remat reruns each block's forward in the backward: K1 and K9 twice
    expect = {False: {"block_sparse_fwd": 2 * n_proj * mb, "block_sparse_dx": n_proj * mb,
                      "block_sparse_dw": n_proj * mb, "flash_fwd": 2 * n_attn * mb,
                      "flash_dq": n_attn * mb, "flash_dkv": n_attn * mb},
              # the update step's gradient is one pass over the full batch
              True: {"block_sparse_fwd": 2 * n_proj, "block_sparse_dx": n_proj,
                     "block_sparse_dw": n_proj, "flash_fwd": 2 * n_attn,
                     "flash_dq": n_attn, "flash_dkv": n_attn}}
    blk = cfg.sparse.block_shape
    log, seen = [], {"counts": None, "t": None, "ev": None, "blocks": None, "prof": None}

    def blocks_of(masks):
        return {n: block_mask_of(m, blk).cpu() for n, m in tree_paths(masks).items()}

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        t, ev = time.perf_counter(), torch.cuda.Event(enable_timing=True)
        ev.record()
        counts = read()
        prev = seen["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if seen["t"] is not None:
            rec["wall_s"] = t - seen["t"]
            rec["device_span_ms"] = seen["ev"].elapsed_time(ev)
        if rec["launches"] != expect[is_update]:
            raise AssertionError(f"train step {step}: launches {rec['launches']}, "
                                 f"expected {expect[is_update]}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"train step {step}: loss {rec['loss']}")
        if step == 1:
            seen["blocks"] = blocks_of(state["masks"])
        if step == 4:  # step 5, a plain step after the update, is profiled
            seen["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            seen["prof"].__enter__()
        elif step == 5:
            seen["prof"].__exit__(None, None, None)
        print("train:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        seen.update(counts=counts, t=time.perf_counter(), ev=torch.cuda.Event(enable_timing=True))
        seen["ev"].record()

    for _, mod, a in counters:
        setattr(mod, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          workdir=str(ROOT / "chiprun_out" / "train"), device="cuda",
                          on_step=on_step, log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # after the drop/grow: counts kept, topology moved, pack fresh and valid,
    # superset around the mask
    after = blocks_of(state["masks"])
    bwd = blocks_of(state["bwd_masks"])
    moved = 0
    for n, b0 in seen["blocks"].items():
        if int(after[n].sum()) != int(b0.sum()):
            raise AssertionError(f"{n}: {int(b0.sum())} active blocks before the "
                                 f"update, {int(after[n].sum())} after")
        if (after[n] & ~bwd[n]).any():
            raise AssertionError(f"{n}: the superset does not contain the mask")
        moved += int((after[n] & ~b0).sum())
    if moved == 0:
        raise AssertionError("the drop/grow moved no block")
    validate_pack(state["pack"], where="chip_smoke")
    stale = int(pack_mismatch(state["masks"], state["pack"], blk, bwd_masks=state["bwd_masks"]))
    if stale:
        raise AssertionError(f"pack stale after the update: {stale} blocks")

    steady = [r for r in log if "wall_s" in r and not r["update"] and r["step"] != 5]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    stats = {"steps": TRAIN_STEPS, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
             "total_s": total_s, "peak_mem_gib": peak_gib, "blocks_moved": moved,
             "mean_train_step_wall_s": wall,
             "mean_train_step_device_span_ms": sum(r["device_span_ms"] for r in steady) / len(steady),
             "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
             "update_step_wall_s": [r["wall_s"] for r in log if r["update"] and "wall_s" in r],
             "losses": [r["loss"] for r in log], "launches_per_step": [r["launches"] for r in log]}
    # device busy time: the kernels' (and copies') own device time; an
    # operator's row repeats the device time of the kernels it launched
    from torch.autograd import DeviceType

    prof = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_ms = sum(dev_us(e) for e in prof) / 1e3
    profiled = next(r for r in log if r["step"] == 5)
    stats["profiled_step_wall_s"] = profiled["wall_s"]
    stats["profiled_step_device_busy_ms"] = busy_ms or None
    top = sorted(prof, key=dev_us, reverse=True)[:25]
    stats["profiled_step_top"] = [(e.key, dev_us(e) / 1e3, e.count) for e in top]
    (ROOT / "chiprun_out" / "train_profile.txt").write_text(
        seen["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{total_s:.1f} s; train step {wall:.3f} s wall = {stats['tok_per_s']:.0f} tok/s; "
          f"device busy {busy_ms:.1f} ms of the profiled step's "
          f"{profiled['wall_s']:.3f} s; peak {peak_gib:.1f} GiB; "
          f"{moved} blocks moved by the drop/grow; launches {launches}")
    return stats, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.attn_sched import sched_for
    from repro_torch.core.pack import pack_np
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import flash_attention as fa

    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    for name in _build.KERNELS:
        log = _build.lib_path(name).with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln]
        print(f"build: {name}: {'; '.join(usage)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    timer = Timer(torch)
    phase_s = {}
    mark = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        phase_s[phase] = round(now - mark[0], 1)
        mark[0] = now
        torch.cuda.empty_cache()

    k1 = k1_cases(torch, timer, bsm, pack_np)
    k9 = k9_cases(torch, timer, fa, sched_for)
    done("parity K1, K9")

    serve_stats, serve_launches, k1_served = main_path(torch, timer, bsm, fa)
    k1 += k1_served
    done("serve")

    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    cfg = train_config()
    # the run's own initial weights, masks, supersets and packs (seed 0;
    # the draws do not depend on the optimizer, so sgd keeps this copy small)
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    k2, k3 = bs_bwd_cases(torch, timer, bsm, pack_np, state, cfg)
    k10, k11 = flash_bwd_cases(torch, timer, fa)
    done("parity K2, K3, K10, K11")
    dense_check = train_dense_check(torch, cfg, state)
    del state
    done("train step-0 check")
    train_stats, train_launches = train_path(torch, bsm, fa, cfg)
    train_stats["step0_vs_dense"] = dense_check
    done("train")

    launches = {n: serve_launches.get(n, 0) + train_launches[n] for n in train_launches}
    by_path = {n: {"serve": serve_launches.get(n, 0), "train": train_launches[n]}
               for n in train_launches}

    def summary(name, source, replaces, cases):
        timed = [c for c in cases if c["library_ms"] is not None]
        total = lambda key: sum(c[key] for c in timed)
        b = sum(c["bound_ms"] for c in timed)
        by_bytes = sum(c["bound_ms"] for c in timed if c["bound_by"] == "bytes")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": b,
            "bound_by": "bytes" if by_bytes >= b / 2 else "operations",
            "library_ms": total("library_ms"),
            "cases_timed": len(timed),
        }

    csrc, kern = "src/repro_torch/csrc/", "src/repro/kernels/"
    report = {"kernels": [
        summary("block_sparse_fwd", csrc + "block_sparse_fwd.cu",
                kern + "block_sparse_matmul.py:223", k1),
        summary("block_sparse_dx", csrc + "block_sparse_bwd.cu",
                kern + "block_sparse_matmul.py:243", k2),
        summary("block_sparse_dw", csrc + "block_sparse_bwd.cu",
                kern + "block_sparse_matmul.py:265", k3),
        summary("flash_fwd", csrc + "flash_fwd.cu", kern + "flash_attention.py:103", k9),
        summary("flash_dq", csrc + "flash_bwd.cu", kern + "flash_attention.py:161", k10),
        summary("flash_dkv", csrc + "flash_bwd.cu", kern + "flash_attention.py:207", k11),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "phase_s": phase_s, "k1": k1, "k2": k2, "k3": k3, "k9": k9,
         "k10": k10, "k11": k11, "engine": serve_stats, "train": train_stats,
         "launches": by_path, "report": report}, indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s; phases {phase_s}")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
