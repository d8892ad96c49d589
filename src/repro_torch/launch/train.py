"""Training entry point of the port: RigL on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 300 --method rigl --sparsity 0.8 --kernel block_sparse --block 128

Port of the JAX package's ``launch/train.py`` (``train_loop`` and
``main``), with the same flags and defaults (Adam without weight decay and
with a global-norm clip of 1.0, warmup-cosine LR, a drop/grow every
``--delta-t`` steps until 3/4 of the run, ``refresh_pack`` after every
update, the pack's staleness checked at log cadence) plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain versions of the kernels,
for smoke configs).  With ``--kernel block_sparse`` every projection runs
the block-sparse CUDA kernels forward (K1), dgrad (K2) and wgrad on the
Top-KAST superset (K3); ``cfg.sparse.attn_kernel='flash_tight'`` (set in
the config, as the reference's tests do: the CLI has no flag for it) runs
attention through the flash kernels K9, K10 and K11.

Not ported yet: checkpoints and restore (``--workdir`` holds only
``result.json``), ``--preempt-at`` and restarts, the observability hooks
and the topology-distance telemetry.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

from ..configs import SparseConfig, get_config
from ..core.masks import mask_stats
from ..core.pack import pack_mismatch
from ..data.synthetic import batch_for
from ..device import resolve_device
from ..optim.lr import LRSchedule
from ..optim.optimizers import OptConfig
from ..training.steps import (
    init_train_state,
    make_algo,
    make_rigl_step,
    make_train_step,
    refresh_pack,
)

__all__ = ["train_loop", "main"]

_UPDATE_METHODS = ("rigl", "set", "snfs", "topkast")


def train_loop(cfg, *, steps: int, batch: int, seq: int, workdir: str,
               opt_cfg: OptConfig | None = None, lr_sched: LRSchedule | None = None,
               learnable: bool = True, log_every: int = 50, seed: int = 0,
               device=None, on_step=None):
    """Train ``steps`` steps from a fresh state -> (state, metrics_log).

    ``on_step(step, is_update, state, metrics)``, if given, runs after every
    step (the chip smoke times steps with it).  Writes
    ``<workdir>/result.json`` with the logged metrics and the final
    sparsity and nnz.
    """
    dev = resolve_device(device)
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    opt_cfg = opt_cfg or OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr_sched = lr_sched or LRSchedule(
        kind="warmup_cosine", base_lr=3e-3, warmup_steps=min(100, steps // 10 + 1),
        total_steps=steps,
    )
    algo = make_algo(cfg, steps)
    state, _ = init_train_state(cfg, opt_cfg, seed=seed, device=dev)
    train_step = make_train_step(cfg, opt_cfg, lr_sched)
    rigl_step = make_rigl_step(cfg, algo, lr_sched)
    sp = cfg.sparse
    metrics_log = []
    t0 = time.time()
    step = state["step"]
    while step < steps:
        b = batch_for(cfg, step, batch, seq, learnable=learnable, device=dev)
        is_update = (sp.method in _UPDATE_METHODS and step > 0
                     and step % sp.delta_t == 0 and step < algo.schedule.t_end)
        if is_update:
            state, m = rigl_step(state, b)
            # the topology changed: re-pack NOW so the next steps' kernels
            # run the new active blocks (host-side, amortized over delta_t)
            state = refresh_pack(state, cfg)
        else:
            state, m = train_step(state, b)
        step = state["step"]
        if on_step is not None:
            on_step(step, is_update, state, m)
        if step % log_every == 0 or step == steps:
            rec = {"step": step, "loss": float(m["loss"])}
            if "lr" in m:  # topology-update steps report loss only
                rec["lr"] = float(m["lr"])
                rec["grad_norm"] = float(m["grad_norm"])
                rec["nonfinite_steps"] = int(m["nonfinite_steps"])
            if "pack" in state:
                # a nonzero count means the kernels run a STALE topology (a
                # topology update without refresh_pack): fail, don't mistrain
                rec["pack_stale"] = stale = int(pack_mismatch(
                    state["masks"], state["pack"], sp.block_shape,
                    bwd_masks=state.get("bwd_masks")))
                if stale:
                    raise RuntimeError(
                        f"PackState is stale ({stale} blocks differ from the "
                        f"masks) at step {step} — a topology update ran "
                        "without refresh_pack()"
                    )
            metrics_log.append(rec)
            print(f"[train] step {step:6d} loss {rec['loss']:.4f} "
                  f"({time.time() - t0:.1f}s)")
    stats = mask_stats(state["masks"])
    (workdir / "result.json").write_text(json.dumps({
        "metrics": metrics_log, "sparsity": stats["sparsity"], "nnz": stats["nnz"],
    }))
    return state, metrics_log


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="h2o-danube-1.8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--method", default="rigl",
                   choices=["rigl", "set", "snfs", "topkast", "static", "snip",
                            "pruning", "dense"],
                   help="the port trains rigl, static and dense; the others "
                        "raise 'not ported yet'")
    p.add_argument("--sparsity", type=float, default=0.8)
    p.add_argument("--distribution", default="erk", choices=["uniform", "er", "erk"])
    p.add_argument("--delta-t", type=int, default=100)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--kernel", default="dense",
                   choices=["dense", "masked", "block_sparse"],
                   help="execution path for sparsifiable matmuls ('masked' is "
                        "not ported yet)")
    p.add_argument("--block", type=int, default=128,
                   help="block edge for --kernel block_sparse (sets block_shape + tiles)")
    p.add_argument("--workdir", default="/tmp/repro_torch_train")
    args = p.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    method = args.method
    sparsity = 0.0 if method == "dense" else args.sparsity
    if method == "dense":
        method = "static"
    sparse_kw = dict(sparsity=sparsity, method=method, distribution=args.distribution,
                     delta_t=args.delta_t, alpha=args.alpha, kernel=args.kernel)
    if args.kernel == "block_sparse":
        sparse_kw["block_shape"] = (args.block, args.block)
        sparse_kw["kernel_block"] = (128, args.block, args.block)
    cfg = dataclasses.replace(cfg, sparse=SparseConfig(**sparse_kw))
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               workdir=args.workdir, device=args.device)


if __name__ == "__main__":
    main()
