#!/usr/bin/env python3
"""Times the head_dim 256 flash kernels (K9, K10) in the layout csrc/ ships
against the alternatives it was chosen over, on the card.

    python3 scripts/flash_d256_tiles.py

Each variant is csrc/flash_fwd.cu or csrc/flash_bwd.cu with its d = 256
warps, key-tile size or launch bound changed (the edits below), built by
nvcc into build/flash_d256_tiles/ and loaded in place of the shipped
library.  Every variant is held against the plain version within
``o_error_bound`` / ``grad_error_bound`` and timed with CUDA events at
gemma3-4b's attention (8 query heads over 4 KV heads, bf16, S = 2048:
window 1024 and global), in the order shipped, variants, shipped; each
with its launch (CTAs an SM, registers, shared and spill bytes).  Prints
one JSON line per (kernel, variant, case) and the card's name and power
limit.  K11 has no alternative here: a warp cannot hold dk and dv at
d = 256, so its layout (warp pairs) is the one that does not spill.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "flash_fwd": {
        "shipped: 8 warps, 32-key tiles, 1 CTA an SM": [],
        "4 warps, 32-key tiles, 2 CTAs an SM": [
            ("return D <= 80 || D > 128 ? 8 : 4;", "return D <= 80 ? 8 : 4;"),
            ("return D > 128 ? 1 : 2;", "return 2;")],
        "4 warps, 64-key tiles, 1 CTA an SM": [
            ("return D <= 80 || D > 128 ? 8 : 4;", "return D <= 80 ? 8 : 4;"),
            ("D > 128 ? 32 : kTileKeys", "D > 128 ? 64 : kTileKeys")],
    },
    "flash_bwd": {
        "shipped: K10 8 warps, 32-key tiles": [],
        "K10 4 warps, 64-key tiles": [
            ("return D <= 80 || D > 128 ? 8 : 4;", "return D <= 80 ? 8 : 4;"),
            ("return D > 128 ? 32 : kTileKeys;", "return D > 128 ? 64 : kTileKeys;")],
        "K10 4 warps, 32-key tiles": [
            ("return D <= 80 || D > 128 ? 8 : 4;", "return D <= 80 ? 8 : 4;")],
    },
}
CASES = (("S=2048 window=1024", 2048, 1024), ("S=2048 global", 2048, 0))


def build_variants(_build):
    """Every variant's library (sources copied with the edits), all nvcc
    processes at once -> {(lib, variant): path}."""
    out_dir = ROOT / "build" / "flash_d256_tiles"
    src = _build.SRC_DIR
    procs, paths = [], {}
    for lib, variants in VARIANTS.items():
        for i, (name, edits) in enumerate(variants.items()):
            d = out_dir / f"{lib}_{i}"
            d.mkdir(parents=True, exist_ok=True)
            for f in src.glob("*.cuh"):
                (d / f.name).write_text(f.read_text())
            text = (src / f"{lib}.cu").read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{lib}: edit {old!r} does not apply")
                text = text.replace(old, new)
            (d / f"{lib}.cu").write_text(text)
            so = d / f"{lib}.so"
            procs.append((lib, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.FLAGS, "-o", str(so), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for lib, name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {lib} ({name}):\n{log}")
        paths[(lib, name)] = so
    return paths


def use(_build, lib, path):
    """Load ``path`` as the library the wrappers call for ``lib``."""
    dll = ctypes.CDLL(str(path))
    dll.kernel_error_string.argtypes = [ctypes.c_int]
    dll.kernel_error_string.restype = ctypes.c_char_p
    _build._LIBS[lib] = dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_d256_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.attn_sched import sched_for
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card = cs.card_line()
    t0 = time.perf_counter()
    paths = build_variants(_build)
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    timer = cs.Timer(torch)
    BH, G, d = 8, 2, 256
    for name, S, window in CASES:
        r = lambda n: torch.randn(n, S, d, device="cuda").to(torch.bfloat16)
        q, k, v, do = r(BH), r(BH // G), r(BH // G), r(BH)
        bq, bk = fa.effective_blocks(S, S)
        sched = fa._schedule_on(q.device, S, S, bq, bk, True, window, 0)
        width = int(sched_for(S, S, bq, bk, True, window, 0)["kv_idx"].shape[1])
        kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                  scale=d ** -0.5, softcap=0.0, kv_groups=G)
        po, plse = fa.flash_attention_plain(q, k, v, sched[0], sched[1], **kw)
        pa, _ = fa.flash_attention_plain(q, k, v.abs(), sched[0], sched[1], **kw)
        delta = (do.float() * po.float()).sum(-1)
        blocks = fa._schedule_mask(sched[0], sched[1], S // bk, q.device)
        want_q, _, _, rq, _, _, eq, _, _ = fa.flash_bwd_plain(
            q, k, v, do, plse, delta, blocks, with_abs=True, **kw)
        for lib, kernel, fn, info in (
                ("flash_fwd", "K9", lambda: fa.flash_fwd(q, k, v, sched[0], sched[1], **kw),
                 "flash_fwd"),
                ("flash_bwd", "K10", lambda: fa.flash_dq(q, k, v, do, plse, delta, sched[0],
                                                         sched[1], **kw), "flash_dq")):
            names = list(VARIANTS[lib])
            for variant in names + names[:1]:
                use(_build, lib, paths[(lib, variant)])
                got = fn()
                if kernel == "K9":
                    ok = bool(((got[0].float() - po.float()).abs()
                               <= fa.o_error_bound(po, pa)).all())
                else:
                    ok = bool(((got.float() - want_q.float()).abs()
                               <= fa.grad_error_bound(want_q, rq, eq)).all())
                if not ok:
                    raise AssertionError(f"{kernel} {variant} {name}: outside the bound")
                print(json.dumps({"kernel": kernel, "variant": variant, "case": name,
                                  "ms": timer(fn, reps=20),
                                  "launch": fa.launch_info(info, d, width)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
