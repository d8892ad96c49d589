#!/usr/bin/env python3
"""Time the block-sparse dgrad (K2, K5) under both orders of its CTA grid on
one CUDA card.

The dgrad kernel (``block_sparse_dx_gemm_kernel`` in
src/repro_torch/csrc/block_sparse_bwd.cuh) takes its grid order from its B
stage's policy, ``gemm::DenseColsB::kRowTilesFastest`` in
src/repro_torch/csrc/gemm_core.cuh: row tiles fastest (the CTAs that read
one block row of w run side by side) or column tiles fastest (the CTAs that
read one row tile of g do).  This script copies the package twice under
build/grid_order/, with the flag set each way, builds both copies' kernels
at once, and times each copy in its own process, in the order rows, cols,
cols, rows: K2 at h2o-danube-1.8b's layer shapes (2048 rows, bf16
attention, f32 MLP) and K5 at qwen2-moe-a2.7b's expert banks (60 experts,
C = 171 rows padded to 256, f32), each on a seeded uniform 20% block mask
of 128 x 128 blocks, on the plan the wrapper picks; CUDA events, L2
flushed before each repetition.  Prints one JSON object per run and their
sums per order.

    python3 scripts/bs_dx_grid_order.py
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "grid_order"
FLAG = "struct DenseColsB : MaskedColsB {\n  static constexpr bool kMasked = false, kRowTilesFastest = "
# (label, G, rows, K, N, dtype name)
CASES = (("danube attn wq", 1, 2048, 2560, 2560, "bfloat16"),
         ("danube attn wk", 1, 2048, 2560, 640, "bfloat16"),
         ("danube mlp wi", 1, 2048, 2560, 6912, "float32"),
         ("danube mlp wo", 1, 2048, 6912, 2560, "float32"),
         ("qwen2-moe bank wi", 60, 256, 2048, 1408, "float32"),
         ("qwen2-moe bank wo", 60, 256, 1408, 2048, "float32"))
LIBS = ("block_sparse_bwd", "block_sparse_grouped", "masked_matmul")


def copy(order: str) -> Path:
    """The package under build/grid_order/<order>/src with the flag set."""
    dst = OUT / order
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    core = dst / "src" / "repro_torch" / "csrc" / "gemm_core.cuh"
    text = core.read_text()
    if text.count(FLAG) != 1:
        raise RuntimeError("gemm_core.cuh: DenseColsB's grid-order flag not found")
    flag = "true" if order == "rows" else "false"
    text = text.replace(FLAG + "true;", FLAG + flag + ";").replace(FLAG + "false;",
                                                                   FLAG + flag + ";")
    core.write_text(text)
    return dst


def run_order(dst: Path) -> dict:
    """Time every case with the copy at ``dst`` (in this process)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(dst / "src"))
    from repro_torch.core.pack import pack_group_mask_rows
    from repro_torch.kernels import block_sparse_matmul as bsm

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    out = {}
    for label, G, M, K, N, dname in CASES:
        dt = getattr(torch, dname)
        bm = rng.random((G, K // 128, N // 128)) < 0.2
        dense = torch.from_numpy(np.repeat(np.repeat(bm, 128, 1), 128, 2)).cuda()
        w = (torch.randn(G, K, N, device="cuda") / N**0.5 * dense).to(dt)
        g = torch.randn(G, M, N, device="cuda").to(dt)
        ridx, rcnt = (torch.from_numpy(a).cuda() for a in pack_group_mask_rows(bm))
        nnz = int(bm.sum())
        if G == 1:
            fn = lambda: bsm.block_sparse_dx(g[0], w[0], ridx[0], rcnt[0], bm=128, bn=128,
                                             bk=128, live=nnz)
        else:
            fn = lambda: bsm.grouped_block_sparse_dx(g, w, ridx, rcnt, bm=128, bn=128, bk=128,
                                                     live=nnz)
        for _ in range(2):
            fn()
        events = []
        for _ in range(10):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        out[label] = sum(a.elapsed_time(b) for a, b in events) / len(events)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(run_order(Path(sys.argv[2]))))
        return 0
    dirs = {order: copy(order) for order in ("rows", "cols")}
    code = "import sys; from repro_torch.kernels import _build; _build.build({!r})".format(LIBS)
    env = lambda d: dict(os.environ, PYTHONPATH=str(d / "src"))
    builds = [subprocess.Popen([sys.executable, "-c", code], cwd=d, env=env(d))
              for d in dirs.values()]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a build failed")
    runs = []
    for order in ("rows", "cols", "cols", "rows"):
        res = subprocess.run([sys.executable, __file__, "--time", str(dirs[order])],
                             capture_output=True, text=True, check=True, env=env(dirs[order]))
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"order": order, "ms": ms, "sum_ms": sum(ms.values())})
        print(json.dumps(runs[-1]))
    sums = {o: [r["sum_ms"] for r in runs if r["order"] == o] for o in ("rows", "cols")}
    print(json.dumps({"sum_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
