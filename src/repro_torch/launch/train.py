"""Training entry point of the port: RigL and the paper's baselines on the
card.

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
Top-KAST superset (K3); with ``--kernel masked`` (elementwise masks, the
paper's unstructured RigL) the masked kernels forward (K13), dgrad (K14)
and wgrad on the superset (K15).  With ``sparse.fused_epilogue`` (a config
field, as in the reference: plain SGD) the wgrad kernel stores the new
momentum instead (K7 under block_sparse, K19 under masked);
``cfg.sparse.attn_kernel='flash_tight'`` (set in
the config, as the reference's tests do: the CLI has no flag for it) runs
attention through the flash kernels K9, K10 and K11.  An MoE config
(``--arch qwen2-moe-a2.7b``) runs its expert banks through the grouped
kernels: K4, K5 and K6 under block_sparse, K16, K17 and K18 under masked,
and the grouped fused epilogues K8 and K20.  The frontend configs train on
``batch_for``'s batches: frames for ``--arch hubert-xlarge``
(``frames_batch``), patches in front of the text for ``--arch
internvl2-1b`` (``vlm_batch``: ``--seq`` counts both).

``--method`` takes every method of the reference's CLI: rigl, set, snfs
and topkast (a drop/grow every ``--delta-t`` steps), static and dense, and
the dense-to-sparse baselines: gradual magnitude pruning (dense start, the
Zhu & Gupta ramp from 1/8 to 3/4 of the run, a prune every ``10 *
--delta-t`` steps, ``refresh_pack`` after each) and SNIP (one-shot masks
from step 0's batch).  Every drop/grow is recorded by a ``TopologyTrace``
(``core/topology.py``): ``result.json`` holds its ``topology`` summary and
the per-update ``topology_updates``.

Fault tolerance, as the reference's: ``--workdir`` holds the run's
checkpoints (``<workdir>/ckpt``: crash-atomic, bit-packed masks, async
saves; ``checkpoint/``), a restarted ``train_loop`` resumes from the newest
valid one (so does a new run given the same ``--workdir``; without it the
CLI makes a new directory under ``$TMPDIR``), and ``run_with_restarts`` (``--max-restarts``) restarts the loop
after a failure; ``--preempt-at N`` stops the run once at step N, after a
forced save, so a resumed run can be held to an uninterrupted one bit for
bit.  Data is a pure function of the step and every random draw of a
(seed, purpose, step), so the state is all a resume needs.
``train_loop(mesh=...)`` trains data-parallel over a ``launch/mesh.py``
mesh (the CLI takes no mesh, as the reference's: a multi-rank run calls
``train_loop`` from its own script after ``init_process_group``).
``--trace-out`` and ``--metrics-out`` turn on the observability layer
(``obs/``): ``train_*`` spans, gauges and histograms, ``topology_update``
instants and the ``kernel_*`` pack gauges, flushed at log cadence.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import tempfile
import time

import torch.distributed as dist

from ..checkpoint.checkpoint import Checkpointer
from ..configs import SparseConfig, get_config
from ..core.masks import mask_stats
from ..core.pack import pack_mismatch, publish_pack_gauges
from ..core.pruning import PruningSchedule
from ..core.topology import TopologyTrace
from ..data.synthetic import batch_for
from ..device import resolve_device
from ..obs import Observability, jit_retraces, kernels_plan_caches
from ..optim.lr import LRSchedule
from ..optim.optimizers import OptConfig
from ..training.steps import (
    init_train_state,
    make_algo,
    make_prune_fn,
    make_rigl_step,
    make_train_step,
    refresh_pack,
    repack,
    snip_init,
)
from .sharding import shard_batch

__all__ = ["SimulatedPreemption", "train_loop", "run_with_restarts", "main"]

_UPDATE_METHODS = ("rigl", "set", "snfs", "topkast")


class SimulatedPreemption(RuntimeError):
    pass


def _train_metrics(obs, state):
    """The reference's train_* metric handles on ``obs`` (bound once)."""
    m = obs.metrics
    obs.trace.thread_name(0, "train")
    om = {
        "loss": m.gauge("train_loss", "last logged training loss"),
        "lr": m.gauge("train_lr", "current learning rate"),
        "gnorm": m.gauge("train_grad_norm", "last logged gradient norm"),
        "stale": m.gauge("train_pack_stale",
                         "pack blocks differing from the masks (must be 0)"),
        "nonfinite": m.gauge("train_nonfinite_steps",
                             "skipped non-finite optimizer updates"),
        "steps": m.counter("train_steps_total", "optimizer steps run"),
        "topo": m.counter("train_topology_updates_total",
                          "drop/grow topology updates applied"),
        "step_s": m.histogram("train_step_seconds", "host-side step dispatch time"),
        "dist": m.gauge("train_topology_distance",
                        "last topology-update distance by metric", labels=("metric",)),
        "retraces": m.gauge("train_retraces",
                            "launch plans built during the run (the port's retraces)"),
    }
    publish_pack_gauges(m, state.get("pack"))
    return om


def train_loop(cfg, *, steps: int, batch: int, seq: int, workdir: str,
               opt_cfg: OptConfig | None = None, lr_sched: LRSchedule | None = None,
               ckpt_every: int | None = 100, preempt_at: int | None = None,
               learnable: bool = True, log_every: int = 50, seed: int = 0,
               obs=None, flusher=None, device=None, on_step=None, mesh=None):
    """One worker attempt -> (state, metrics_log).  Raises on a (simulated)
    failure; restartable: it resumes from ``<workdir>/ckpt``.

    Checkpoints as the reference's: every ``ckpt_every`` steps (0: only
    the forced ones), a forced save at ``preempt_at`` (then
    ``SimulatedPreemption``) and at the end; ``ckpt_every=None`` turns
    checkpoints off (no restore, no save).  A restored state is re-packed
    against its own masks and supersets (``repack``, the saved pack as
    ``prev``).  ``obs`` (an ``obs.Observability``) turns on the train_*
    spans, counter tracks, gauges and histograms, ``topology_update``
    instants and the kernel_* pack gauges after every refresh; ``flusher``
    (``obs.flusher(...)``) is pumped at log cadence and closed at the end.
    ``on_step(step, is_update, state, metrics)``, if given, runs after every
    step (the chip smoke times steps with it).  Writes
    ``<workdir>/result.json`` with the logged metrics, the final sparsity
    and nnz, and the topology telemetry of the drop/grow updates.

    ``mesh`` (a ``launch/mesh.py`` device mesh over the live process group):
    data parallelism.  Every rank builds the same state and the same global
    batch from the seed and keeps its rows (``shard_batch``); the steps
    all-reduce the gradient (``training/steps.py``).  Rank 0 alone writes
    the workdir's files (checkpoints, result.json) and every rank restores
    the same replicated state from them, so a restore onto another world
    size needs nothing more.  A restore onto a sharded mesh is ROADMAP
    queue A item 9b.
    """
    dev = resolve_device(device)
    writer = mesh is None or dist.get_rank() == 0
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    opt_cfg = opt_cfg or OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr_sched = lr_sched or LRSchedule(
        kind="warmup_cosine", base_lr=3e-3, warmup_steps=min(100, steps // 10 + 1),
        total_steps=steps,
    )
    algo = make_algo(cfg, steps)
    state, _ = init_train_state(cfg, opt_cfg, seed=seed, device=dev)
    ckpt = None if ckpt_every is None else Checkpointer(workdir / "ckpt", every=ckpt_every)
    if ckpt is not None:
        restored, rstep = ckpt.restore_or_none(state)
        if restored is not None:
            del state
            state = repack(restored, cfg)
            print(f"[train] restored checkpoint at step {rstep}")
    train_step = make_train_step(cfg, opt_cfg, lr_sched, mesh=mesh)
    rigl_step = make_rigl_step(cfg, algo, lr_sched, mesh=mesh)
    prune_sched = PruningSchedule(
        cfg.sparse.sparsity, begin_step=steps // 8, end_step=int(steps * 0.75),
        prune_every=max(cfg.sparse.delta_t * 10, 1))
    prune_fn = make_prune_fn(cfg, prune_sched) if cfg.sparse.method == "pruning" else None
    sp = cfg.sparse

    def batch_at(step):
        b = batch_for(cfg, step, batch, seq, learnable=learnable, device=dev)
        return b if mesh is None else shard_batch(b, mesh)

    if sp.method == "snip" and state["step"] == 0:
        state = snip_init(state, cfg, batch_at(0), mesh=mesh)
        state = refresh_pack(state, cfg)  # snip replaced the masks
    metrics_log = []
    topo_log = []  # per-update records, kept apart from the loss log
    topo_trace = TopologyTrace()
    plans = kernels_plan_caches()
    plans0 = jit_retraces(*plans)
    om = None if obs is None else _train_metrics(obs, state)
    t0 = time.time()
    step = state["step"]
    while step < steps:
        ts0 = time.time()
        b = batch_at(step)
        is_update = (sp.method in _UPDATE_METHODS and step > 0
                     and step % sp.delta_t == 0 and step < algo.schedule.t_end)
        if is_update:
            prev_masks = topo_trace.snapshot(state["masks"])
            state, m = rigl_step(state, b)
            # the topology changed: re-pack NOW so the next steps' kernels
            # run the new active blocks (host-side, amortized over delta_t)
            state = refresh_pack(state, cfg)
            rec = topo_trace.record(prev_masks, state["masks"], step=step)
            del prev_masks
            topo_log.append({"step": step, "topology": rec})
            if om is not None:
                om["topo"].inc()
                for k in ("jaccard_dist", "graph_edit_dist", "nhd"):
                    om["dist"].labels(k).set(rec[k])
                obs.trace.instant(
                    "topology_update", time.time() - t0, tid=0, cat="train",
                    args={"step": step, **{k: rec[k] for k in
                          ("dropped", "grown", "jaccard_dist", "nhd")}})
                publish_pack_gauges(obs.metrics, state.get("pack"))
        else:
            state, m = train_step(state, b)
        if prune_fn is not None and step % prune_sched.prune_every == 0:
            state = prune_fn(state)
            state = refresh_pack(state, cfg)  # pruning moved the masks too
            if om is not None:
                publish_pack_gauges(obs.metrics, state.get("pack"))
        step = state["step"]
        if on_step is not None:
            on_step(step, is_update, state, m)
        if om is not None:
            # host-side dispatch slice: the log-cadence block below is where
            # queued device work drains
            ts1 = time.time()
            obs.trace.span("topology_update_step" if is_update else "train_step",
                           ts0 - t0, ts1 - t0, tid=0, cat="train", args={"step": step})
            om["step_s"].observe(ts1 - ts0)
            om["steps"].inc()
        if preempt_at is not None and step == preempt_at:
            if ckpt is not None and writer:
                ckpt.maybe_save(state, step, force=True)
                ckpt.wait()
            if mesh is not None:
                dist.barrier()  # the save lands before any rank restores it
            raise SimulatedPreemption(f"preempted at step {step}")
        if step % log_every == 0 or step == steps:
            rec = {"step": step, "loss": float(m["loss"])}
            if "lr" in m:  # topology-update steps report loss only
                rec["lr"] = float(m["lr"])
                rec["grad_norm"] = float(m["grad_norm"])
                rec["nonfinite_steps"] = int(m["nonfinite_steps"])
            # launch plans built during the run: growth in steady state is
            # the pack-width-hysteresis signal (the reference's retraces)
            rec["n_retraces"] = jit_retraces(*plans) - plans0
            if om is not None:
                tnow = time.time() - t0
                om["loss"].set(rec["loss"])
                om["retraces"].set(rec["n_retraces"])
                track = {"loss": rec["loss"]}
                if "lr" in rec:
                    om["lr"].set(rec["lr"])
                    om["gnorm"].set(rec["grad_norm"])
                    om["nonfinite"].set(rec["nonfinite_steps"])
                    track["grad_norm"] = rec["grad_norm"]
                obs.trace.counter("train", tnow, track, tid=0)
                if flusher is not None:
                    flusher.maybe_flush(tnow)
            if "pack" in state and sp.kernel == "block_sparse":
                # a nonzero count means the kernels run a STALE topology (a
                # topology update without refresh_pack): fail, don't mistrain
                rec["pack_stale"] = stale = int(pack_mismatch(
                    state["masks"], state["pack"], sp.block_shape,
                    bwd_masks=state.get("bwd_masks")))
                if om is not None:
                    om["stale"].set(stale)
                if stale:
                    raise RuntimeError(
                        f"PackState is stale ({stale} blocks differ from the "
                        f"masks) at step {step} — a topology update ran "
                        "without refresh_pack()"
                    )
            metrics_log.append(rec)
            if writer:
                print(f"[train] step {step:6d} loss {rec['loss']:.4f} "
                      f"({time.time() - t0:.1f}s)")
        if ckpt is not None and writer:
            ckpt.maybe_save(state, step)
    if ckpt is not None and writer:
        ckpt.maybe_save(state, step, force=True)
        ckpt.wait()
    if flusher is not None:
        flusher.close(time.time() - t0)
    if writer:
        stats = mask_stats(state["masks"])
        (workdir / "result.json").write_text(json.dumps({
            "metrics": metrics_log, "sparsity": stats["sparsity"], "nnz": stats["nnz"],
            "topology": topo_trace.summary(), "topology_updates": topo_log,
        }))
    return state, metrics_log


def run_with_restarts(max_restarts: int = 3, **kw):
    """The fault-tolerance wrapper a cluster scheduler would drive: rerun
    ``train_loop(**kw)`` after a ``SimulatedPreemption`` (which preempts
    once), up to ``max_restarts`` times."""
    attempt = 0
    while True:
        try:
            return train_loop(**kw)
        except SimulatedPreemption as e:
            attempt += 1
            print(f"[train] {e}; restart {attempt}/{max_restarts}")
            kw["preempt_at"] = None  # only preempt once
            if attempt > max_restarts:
                raise


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
                            "pruning", "dense"])
    p.add_argument("--sparsity", type=float, default=0.8)
    p.add_argument("--distribution", default="erk", choices=["uniform", "er", "erk"])
    p.add_argument("--delta-t", type=int, default=100)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--kernel", default="dense",
                   choices=["dense", "masked", "block_sparse"],
                   help="execution path for sparsifiable matmuls")
    p.add_argument("--block", type=int, default=128,
                   help="block edge for --kernel block_sparse (sets block_shape + tiles)")
    p.add_argument("--workdir", default=None,
                   help="checkpoints and result.json; a workdir that holds a "
                        "checkpoint resumes from it.  Default: a new directory "
                        "under $TMPDIR, so a run never restores another's")
    p.add_argument("--preempt-at", type=int, default=None)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome-trace JSON here (Perfetto / chrome://tracing)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write Prometheus text-exposition metrics here "
                        "(rewritten at log cadence)")
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
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_torch_train-")
    print(f"[train] workdir {workdir}")
    obs = flusher = None
    if args.trace_out or args.metrics_out:
        obs = Observability(pid=1, process_name="train")
        flusher = obs.flusher(metrics_path=args.metrics_out, trace_path=args.trace_out)
    return run_with_restarts(
        max_restarts=args.max_restarts, cfg=cfg, steps=args.steps, batch=args.batch,
        seq=args.seq, workdir=workdir, preempt_at=args.preempt_at, obs=obs,
        flusher=flusher, device=args.device)


if __name__ == "__main__":
    main()
