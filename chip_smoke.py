#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (src/repro_torch/) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  -- the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   -- nvcc builds every kernel from csrc/ into build/kernels/
  3. parity  -- each kernel against its plain PyTorch version on the card, at
                the main path's shapes, with the stated tolerance; each case
                timed with CUDA events (kernel, plain version, one PyTorch
                library call as a yardstick) beside its roofline bound
  4. main    -- serve h2o-danube-1.8b at full width and depth
                (block_sparse, block 128, flash_tight, ERK sparsity 0.8,
                seed 0): 8 staggered greedy requests x 32 tokens through
                ServeEngine; every request DONE, no quarantine, each kernel
                launched, and the kernel path's prefill and first decode
                logits within tolerance of the plain dense path on the same
                weights; then the decode step's device time (CUDA graph),
                the device time of its 168 K1 launches on the served packs,
                and K1 parity and timings on layer 0's ERK packs
  5. report  -- one JSON line of per-kernel numbers, the card line, and last
                {"ok": true, "device": {...}}

Per-case details also go to chiprun_out/chip_smoke.json.  Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
L2_BYTES = 50 * 2**20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


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
    # both accumulate in f32 and round once to bf16: one bf16 ulp of the
    # largest output at most
    err = (y.float() - ref.float()).abs().max().item()
    tol = 2.0**-7 * ref.float().abs().max().item()
    if err > tol:
        raise AssertionError(f"K1 {label}: err {err} > tol {tol}")
    # the served function's bytes and flops: its M rows, not the padded Mp
    nnz = int(cnt.sum())
    b_ms, by = bound_ms(
        2 * (M * K + nnz * blk * blk + M * N) + 4 * (idx.numel() + cnt.numel()),
        2.0 * M * nnz * blk * blk,
    )
    case = {
        "case": f"{label} M={M}->{Mp} K={K} N={N} blocks={nnz}/{K // blk * N // blk}",
        "max_abs_err": err, "tol": tol,
        "ms": timer(lambda: bsm.block_sparse_matmul(xp, w, idx, cnt, bm=bm, bn=blk, bk=blk)),
        "plain_ms": timer(lambda: bsm.block_sparse_matmul_plain(xp, w, idx, cnt, blk, blk), reps=5),
        "library_ms": timer(lambda: x @ w),
        "bound_ms": b_ms, "bound_by": by,
    }
    print("K1", json.dumps(case))
    return case, y


def k1_cases(torch, timer, bsm, pack_np):
    """K1 at the main path's shapes: decode (4 rows -> 16) and prefill (512
    rows) over each danube projection shape, 80% block sparsity, one empty
    column."""
    import numpy as np

    rng = np.random.default_rng(0)
    blk = 128
    out = []
    for K, N in ((2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)):
        nkb, nnb = K // blk, N // blk
        bm = np.zeros(nkb * nnb, bool)
        bm[rng.choice(nkb * nnb, round(0.2 * nkb * nnb), replace=False)] = True
        bm = bm.reshape(nkb, nnb)
        bm[:, 1] = False  # an all-empty column must come out as zeros
        dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 0), blk, 1)).cuda()
        w = (torch.randn(K, N, device="cuda") / K**0.5 * dense).to(torch.bfloat16)
        idx, cnt = (torch.from_numpy(a).cuda() for a in pack_np(bm))
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda").to(torch.bfloat16)
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
    shape at its ERK density), at a decode step's 4 rows and at the 1024
    rows of the longest prompt bucket."""
    blk = engine.cfg.sparse.kernel_block[2]
    out = []
    for name, w, e in packed_projections(engine, 0):
        for M in (4, 1024):
            x = torch.randn(M, w.shape[0], device="cuda").to(torch.bfloat16)
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
            x = torch.randn(16, w.shape[0], device="cuda").to(torch.bfloat16)
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
    k1 = k1_cases(torch, timer, bsm, pack_np)
    k9 = k9_cases(torch, timer, fa, sched_for)
    torch.cuda.empty_cache()

    stats, launches, k1_served = main_path(torch, timer, bsm, fa)
    k1 += k1_served

    def summary(name, source, replaces, cases):
        timed = [c for c in cases if c["library_ms"] is not None]
        total = lambda key: sum(c[key] for c in timed)
        b = sum(c["bound_ms"] for c in timed)
        by_bytes = sum(c["bound_ms"] for c in timed if c["bound_by"] == "bytes")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": b,
            "bound_by": "bytes" if by_bytes >= b / 2 else "operations",
            "library_ms": total("library_ms"),
            "cases_timed": len(timed),
        }

    report = {"kernels": [
        summary("block_sparse_fwd", "src/repro_torch/csrc/block_sparse_fwd.cu",
                "src/repro/kernels/block_sparse_matmul.py:223", k1),
        summary("flash_fwd", "src/repro_torch/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_attention.py:103", k9),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "k1": k1, "k9": k9, "engine": stats,
         "launches": launches, "report": report}, indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
