#!/usr/bin/env python3
"""Time the split merges of the block-sparse wgrad on one CUDA card: K3/K6's
packed merge (``bs_dw_merge``) and, where the package has it, K7/K8's fused
merge (``bs_dw_fused_merge``: the ordered sum, then the momentum epilogue
with sr).

Each tree given (a checkout's root, by default this one) is timed in its
own process, in the order given, so that two versions of the merge kernels
can be compared in one run on one card (for example a checkout of a parent
commit and this one: parent, change, change, parent).  The shape is
h2o-danube-1.8b's f32 MLP wgrad (2560 x 6912, 128 x 128 blocks, a seeded
block mask of ~26% density) split in 4, timed with chip_smoke.py's Timer
(CUDA events, L2 flushed before each repetition), three times each.
Prints one line per tree.

    python3 scripts/bs_dw_merge_time.py [ROOT ...]
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

K, N, BLK, N_SPLIT = 2560, 6912, 128, 4


def time_tree(root: str) -> dict:
    sys.path[:0] = [f"{root}/src", root]
    import numpy as np
    import torch

    from chip_smoke import Timer
    from repro_torch.core.pack import pack_np
    from repro_torch.kernels import block_sparse_matmul as bsm

    bm = np.random.default_rng(0).random((K // BLK, N // BLK)) < 0.26
    idx, cnt = (torch.from_numpy(a).cuda() for a in pack_np(bm))
    part = torch.randn(N_SPLIT, 1, N // BLK, idx.shape[1], BLK, BLK, device="cuda")
    out = torch.zeros(K, N, device="cuda")
    timer = Timer(torch)
    res = {"root": root, "card": torch.cuda.get_device_name(0), "live": int(bm.sum()),
           "k3_merge_us": [1e3 * timer(lambda: bsm.bs_dw_merge(part, idx, cnt, out))
                           for _ in range(3)]}
    if hasattr(bsm, "bs_dw_fused_merge"):
        w = torch.randn(K, N, device="cuda")
        mom = torch.randn(K, N, device="cuda").bfloat16()
        res["k7_merge_us"] = [1e3 * timer(lambda: bsm.bs_dw_fused_merge(
            part, idx, cnt, w, mom, out, 7, mu=0.9, wd=1e-4, sr=True)) for _ in range(3)]
    return res


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(time_tree(sys.argv[2])))
        return 0
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for root in roots:
        r = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        print(r.stdout.strip() or r.stderr[-2000:])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
