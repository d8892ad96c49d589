#!/usr/bin/env python3
"""Run chip_smoke.py's grok-1-314b phases alone on one CUDA card.

    python3 scripts/grok_phases.py [--only flash,banks,serve,train]

Builds the kernels (``kernels/_build.py``), then runs the phases
``chip_smoke.grok_phases`` runs in the whole smoke (K9-K11 at grok's
attention with softcap 30, K4-K6 and K16-K18 on a whole 1.61 G-element
expert bank, the 4-layer serve and the 1-layer train in both kernel modes),
or the ``--only`` subset, with the same checks.  Prints the card line,
each phase's seconds, and writes every number to
``chiprun_out/grok_phases.json``.  Exits non-zero on a failed check or
without a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("flash", "banks", "serve", "train")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=",".join(PHASES),
                   help=f"comma-separated subset of {PHASES}")
    only = p.parse_args().only.split(",")
    import torch

    if not torch.cuda.is_available():
        print("grok_phases: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_matmul as mm

    card = cs.card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    timer = cs.Timer(torch)
    phase_s, out = {}, {"card": card}
    for phase in only:
        t0 = time.perf_counter()
        if phase == "flash":
            out["flash"] = dict(zip(("k9", "k10", "k11"), cs.grok_flash_cases(torch, timer, fa)))
        elif phase == "banks":
            out["banks"] = cs.grok_bank_cases(torch, timer, bsm, mm)
        elif phase == "serve":
            out["serve"] = {k: v[0] if k in ("block_sparse", "masked") else v
                            for k, v in cs.grok_serve(torch, timer, bsm, mm, fa).items()}
        elif phase == "train":
            for kernel in ("block_sparse", "masked"):
                out[f"train {kernel}"] = cs.grok_train(torch, timer, bsm, mm, fa, kernel)[0]
        else:
            raise SystemExit(f"unknown phase {phase!r} (one of {PHASES})")
        torch.cuda.synchronize()
        phase_s[phase] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    out["phase_s"] = phase_s
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "grok_phases.json").write_text(json.dumps(out, indent=1, default=str))
    print(f"phases {phase_s}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
