#!/usr/bin/env python3
"""Time the masked fused SGD wgrad (K19, K20) against the masked wgrad
(K15, K18) and the unfused step (K15/K18, then the SGD update in PyTorch)
on the same inputs, on one CUDA card.

K19/K20 are K15/K18's kernel (``masked_gemm_kernel`` in
src/repro_torch/csrc/masked_matmul.cu) with the ``Momentum`` epilogue: after
the walk a CTA stages its tile's w and mom rows into the ring's shared
memory and folds mu * mom + acc + wd * w there, so the fused kernel's time
over K15/K18's is the cost of that store.  Cases: K19 at
h2o-danube-1.8b's and qwen2-moe-a2.7b's 2-D projections (2048 rows, bf16
attention, f32 MLP) and K20 at qwen2-moe-a2.7b's expert banks (60 experts,
C = 171 rows padded to 256, and 16 rows), each on a seeded uniform 30%
wgrad mask, bf16 momentum, sr on, the plan the wrapper picks.  CUDA events,
L2 flushed and the card kept busy by a spin kernel while the host enqueues
each repetition (as chip_smoke.py's Timer).  Prints the card, one JSON
object per case and the sums.

    python3 scripts/masked_fused_epilogue.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (label, G, rows, K, N, dtype name)
CASES = (("danube attn wq", 1, 2048, 2560, 2560, "bfloat16"),
         ("danube attn wk", 1, 2048, 2560, 640, "bfloat16"),
         ("danube mlp wi", 1, 2048, 2560, 6912, "float32"),
         ("danube mlp wo", 1, 2048, 6912, 2560, "float32"),
         ("qwen2-moe attn wq", 1, 2048, 2048, 2048, "bfloat16"),
         ("qwen2-moe shared wi", 1, 2048, 2048, 5632, "float32"),
         ("qwen2-moe bank wi C=256", 60, 256, 2048, 1408, "float32"),
         ("qwen2-moe bank wo C=256", 60, 256, 1408, 2048, "float32"),
         ("qwen2-moe bank wi 16 rows", 60, 16, 2048, 1408, "float32"),
         ("qwen2-moe bank wi 16 rows bf16", 60, 16, 2048, 1408, "bfloat16"))
MU, WD = 0.9, 1e-4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import masked_matmul as mm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(fn):
        for _ in range(2):
            fn()
        events = []
        for _ in range(10):
            flush.zero_()
            torch.cuda._sleep(2_000_000)  # ~1 ms: the host enqueues the call meanwhile
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / len(events)

    sums = {"fused_ms": 0.0, "dw_ms": 0.0, "unfused_ms": 0.0}
    for label, G, M, K, N, dname in CASES:
        dt = getattr(torch, dname)
        rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
        m = torch.rand(G, K, N, device="cuda", generator=gen) < 0.3
        x, g = rnd(G, M, K).to(dt), (rnd(G, M, N) / M**0.5).to(dt)
        w = (rnd(G, K, N) / K**0.5).to(dt)
        mom = (0.01 * rnd(G, K, N) * m).to(torch.bfloat16)
        kw = dict(mu=MU, wd=WD, sr=True, bn=128, bk=128)
        if G == 1:
            fused = lambda: mm.masked_dw_fused(x[0], g[0], m[0], w[0], mom[0], 7, **kw)
            dw = lambda: mm.masked_dw(x[0], g[0], m[0], bn=128, bk=128)
        else:
            fused = lambda: mm.grouped_masked_dw_fused(x, g, m, w, mom, 7, **kw)
            dw = lambda: mm.grouped_masked_dw(x, g, m, bn=128, bk=128)
        update = lambda d: ((MU * mom.float() + d.float().view(m.shape) + WD * w.float())
                            * m).to(dt)
        row = {"case": label, "fused_ms": timed(fused), "dw_ms": timed(dw),
               "unfused_ms": timed(lambda: update(dw()))}
        for k in sums:
            sums[k] += row[k]
        print(json.dumps(row))
        del x, g, w, mom, m
        torch.cuda.empty_cache()
    print(json.dumps({"sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
