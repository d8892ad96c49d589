#!/usr/bin/env python3
"""Run chip_smoke.py's remat and data-parallel phases alone on one CUDA card.

    python3 scripts/remat_dp_phases.py [--only remat,dp]

Builds the kernels (``kernels/_build.py``), then runs the phases
``chip_smoke.remat_phase`` (remat_policy='dots' against 'none' on
h2o-danube-1.8b at full width, 4 of 24 layers) and ``chip_smoke.dp_phase``
(one process, two gloo ranks on the one card, one NCCL rank), or the
``--only`` subset, with the same checks.  Prints the card line and each
phase's seconds, and writes every number to
``chiprun_out/remat_dp_phases.json``.  Exits non-zero on a failed check or
without a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("remat", "dp")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=",".join(PHASES),
                   help=f"comma-separated subset of {PHASES}")
    only = p.parse_args().only.split(",")
    import torch

    if not torch.cuda.is_available():
        print("remat_dp_phases: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import flash_attention as fa

    card = cs.card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    phase_s, out = {}, {"card": card}
    for phase in only:
        t0 = time.perf_counter()
        if phase == "remat":
            out["remat"], out["remat_launches"] = cs.remat_phase(torch, bsm, fa)
        elif phase == "dp":
            out["dp"], out["dp_rank0_launches"], out["dp_single_launches"] = cs.dp_phase(
                torch, bsm, fa)
        else:
            raise SystemExit(f"unknown phase {phase!r} (one of {PHASES})")
        torch.cuda.synchronize()
        phase_s[phase] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    out["phase_s"] = phase_s
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "remat_dp_phases.json").write_text(json.dumps(out, indent=1, default=str))
    print(f"phases {phase_s}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
