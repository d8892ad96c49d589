"""Serving driver of the port: the continuous-batching engine (default) or
the lockstep baseline, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --kernel block_sparse --block 128 --attn-kernel flash_tight

Port of the JAX package's ``launch/serve.py`` (engine mode), with the same
flags plus ``--device`` (default ``cuda``; ``--device cpu`` runs the plain
versions of the kernels, for smoke configs).  With ``--kernel block_sparse``
every projection of prefill and decode runs the block-sparse CUDA kernel on
the serve state's PackState, packed once, and an MoE config's expert banks
(``--arch qwen2-moe-a2.7b``) the grouped kernel K4 on their stacked
per-expert packs; with ``--kernel masked`` the masked kernels (K13, and
K16 for the banks) on the weights and their elementwise masks; with
``--attn-kernel flash_tight``
prefill attention runs the flash CUDA kernel on the prompt's AttnSchedule.
``--paged`` pages the KV caches and ``--prefix-cache N`` shares prompt
prefixes (a hit's suffix prefill runs the paged flash kernel K12), as in
the reference.  Sampling is reached through the ``Request`` fields
(``staggered_requests(temperature=, top_k=)``), as in the reference CLI.
``--max-retries`` bounds the engine's quarantine retries; ``--trace-out``
and ``--metrics-out`` write the engine's Chrome trace and Prometheus
metrics after the run (``obs/``).  ``--lockstep`` runs ``serve_session``
instead: one fixed batch (``--batch``, ``--prompt-len``, ``--gen``) with
one shared position, every row decoding until the last is done — the
baseline the engine is measured against.  A patch config's requests
(``--arch internvl2-1b``) carry their prompts' patch embeddings; an
encoder config (``--arch hubert-xlarge``) has no serve path and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, validate_sparse_kernel
from ..core.distributions import sparsity_map
from ..core.masks import apply_masks_, init_masks, tree_paths
from ..core.pack import build_pack_state
from ..data.synthetic import batch_for
from ..device import resolve_device
from ..models.model import init_lm, lm_decode, lm_prefill, serving_weights
from ..obs import Observability
from ..serving.engine import ServeEngine
from ..serving.queue import Request, poisson_arrivals

__all__ = ["serve_session", "configure_kernel", "staggered_requests",
           "init_serving_state", "main"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_session(cfg, params, *, batch: int, prompt_len: int, gen: int,
                  max_len: int | None = None, masks=None, pack=None, prompt=None,
                  patches=None):
    """Greedy lockstep generation -> (tokens (B, gen), stats), the
    reference's ``serve_session``: one prefill of the whole batch, then
    ``gen - 1`` decode steps at one shared scalar position.

    ``params`` are the f32 masters (or ``serving_weights`` of them); masks
    and pack follow the kernel-dispatch contract of ``ServeEngine``.
    ``prompt``: (B, prompt_len) int tokens; by default the port's
    ``batch_for(cfg, 0, batch, prompt_len + 1, learnable=True)`` cut to
    ``prompt_len``, as the reference builds its prompt from its own
    stream.  ``tok_per_s`` counts all ``batch * gen`` tokens over the
    prefill and decode time (the first token comes from the prefill).

    A ``patch`` config's prompt carries ``patches`` (B, n_patches,
    frontend_dim) in front of its text (by default the port's ``batch_for``
    draws them beside a text of ``prompt_len`` tokens), so the cache holds
    ``n_patches`` rows more and decode positions start at ``prompt_len +
    n_patches``, as the reference's.  An encoder config (hubert's frames)
    raises: it has no decode step, as the reference's prefill refuses it."""
    if not cfg.causal:
        raise ValueError(f"serve_session: config {cfg.name!r} is an encoder "
                         "(no prefill/decode)")
    n_patches = cfg.n_patches if cfg.frontend == "patch" else 0
    max_len = max_len or (prompt_len + n_patches + gen)
    w = serving_weights(params, cfg)
    dev = w["embed"]["table"].device
    if prompt is None or (n_patches and patches is None):
        drawn = batch_for(cfg, 0, batch, prompt_len + 1 + n_patches, learnable=True,
                          device=dev)
        prompt = drawn["tokens"][:, :prompt_len] if prompt is None else prompt
        patches = drawn.get("patches") if patches is None else patches
    inputs = {"tokens": prompt.to(dev)}
    if n_patches:
        inputs["patches"] = patches.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = lm_prefill(w, cfg, inputs, max_len, masks=masks, pack=pack)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = lm_decode(w, cfg, caches, tok, prompt_len + n_patches + i,
                                   masks=masks, pack=pack)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill,
        "decode_s_per_tok": t_decode / max(gen - 1, 1),
        "tok_per_s": batch * gen / max(t_prefill + t_decode, 1e-9),
    }


def staggered_requests(cfg, n: int, *, prompt_lens=(16, 32),
                       gen_lens=(8, 16, 32, 64), arrival_rate: float = 0.0,
                       seed: int = 0, temperature: float = 0.0, top_k: int = 0):
    """Synthetic staggered-length workload, the same requests as the
    reference's for the same arguments: request i cycles through
    ``prompt_lens``/``gen_lens`` with Poisson arrival offsets at
    ``arrival_rate`` req/s (0 => burst at t=0); a ``patch`` config's
    request carries (n_patches, frontend_dim) standard normal f32 patches,
    drawn before its tokens from the same numpy stream."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, arrival_rate, seed)
    reqs = []
    for i in range(n):
        kw = {}
        if cfg.frontend == "patch":
            kw["patches"] = rng.standard_normal(
                (cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        reqs.append(Request(
            rid=i,
            tokens=rng.integers(
                0, cfg.vocab_size, size=int(prompt_lens[i % len(prompt_lens)])
            ).astype(np.int32),
            max_new_tokens=int(gen_lens[i % len(gen_lens)]),
            temperature=temperature, top_k=top_k, seed=seed + i,
            arrival=float(arrivals[i]), **kw,
        ))
    return reqs


def configure_kernel(cfg, *, kernel=None, block=None, attn_kernel=None):
    """Apply CLI kernel overrides to cfg.sparse; block_sparse couples
    block_shape to the kernel tiles (bk, bn) = (block, block)."""
    sp = cfg.sparse
    if kernel == "block_sparse":
        e = block or sp.kernel_block[2]
        sp = dataclasses.replace(
            sp, kernel="block_sparse", block_shape=(e, e),
            kernel_block=(sp.kernel_block[0], e, e),
        )
    elif kernel is not None:
        sp = dataclasses.replace(sp, kernel=kernel)
    if attn_kernel is not None:
        sp = dataclasses.replace(sp, attn_kernel=attn_kernel)
    return dataclasses.replace(cfg, sparse=sp)


def init_serving_state(cfg, seed: int = 0, *, device=None):
    """Fresh weights ready to serve -> (params, masks, pack).

    ``init_lm`` -> ERK ``sparsity_map`` -> ``init_masks`` (block-aligned
    under block_sparse) -> ``apply_masks_`` (in place) -> ``build_pack_state``.
    Kernel-dispatch modes serve the masked weights with their masks (and
    the pack under block_sparse; ``None`` under masked, whose forward needs
    no superset carrier); dense mode serves pre-masked weights with masks
    and pack None, as the reference.  On ``device`` (default cuda).
    """
    sp = cfg.sparse
    validate_sparse_kernel(sp)
    dev = resolve_device(device)
    params, flags = init_lm(cfg, seed, device=dev)
    masks = None
    if sp.sparsity > 0.0:
        smap = sparsity_map(cfg, params, flags)
        if sp.kernel == "block_sparse":
            flat = tree_paths(params)
            # a 3-D weight bank (MoE experts) tiles by its trailing two dims
            bad = [n for n in smap if flat[n].dim() not in (2, 3)
                   or flat[n].shape[-2] % sp.block_shape[0]
                   or flat[n].shape[-1] % sp.block_shape[1]]
            if bad:
                raise ValueError(
                    f"block_shape={sp.block_shape} does not tile the "
                    f"sparsifiable layers {bad}"
                )
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        masks = init_masks(gen, params, smap, block_shape=sp.block_shape)
        params = apply_masks_(params, masks)
    if sp.kernel == "masked" and masks is not None:
        return params, masks, None
    if sp.kernel != "block_sparse" or masks is None:
        return params, None, None
    pack = build_pack_state(masks, sp.block_shape,
                            slack=sp.pack_width_slack, device=dev)
    return params, masks, pack


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="h2o-danube-1.8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--capacity", type=int, default=4,
                   help="engine slot-pool size (the decode batch)")
    p.add_argument("--requests", type=int, default=16,
                   help="number of staggered-length requests to serve")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson arrival rate, req/s (0 = burst at t=0)")
    p.add_argument("--max-len", type=int, default=128,
                   help="per-slot cache length (prompt + generation bound)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="max queued requests before submit sheds")
    p.add_argument("--deadline", type=float, default=None,
                   help="admission deadline in seconds from arrival")
    p.add_argument("--max-retries", type=int, default=0,
                   help="quarantine-retry budget per request")
    p.add_argument("--paged", action="store_true",
                   help="page the KV caches: per-slot block tables over "
                   "shared page pools")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page (must divide --max-len and each "
                   "local ring length)")
    p.add_argument("--n-blocks", type=int, default=None,
                   help="global page-pool size (default: capacity * max_len "
                   "/ page_size, i.e. no oversubscription)")
    p.add_argument("--prefix-cache", type=int, default=0,
                   help="max LRU-registered shared prefixes for copy-on-write "
                   "prefix reuse (0 = off; needs --paged and an all-global "
                   "config)")
    p.add_argument("--lockstep", action="store_true",
                   help="run the fixed-batch serve_session baseline instead")
    p.add_argument("--batch", type=int, default=4, help="lockstep only")
    p.add_argument("--prompt-len", type=int, default=48, help="lockstep only")
    p.add_argument("--gen", type=int, default=32, help="lockstep only")
    p.add_argument("--kernel", default=None,
                   choices=["dense", "masked", "block_sparse"],
                   help="override cfg.sparse.kernel for serving")
    p.add_argument("--block", type=int, default=None,
                   help="block edge for --kernel block_sparse")
    p.add_argument("--attn-kernel", default=None,
                   choices=["dense", "flash", "flash_tight"],
                   help="override cfg.sparse.attn_kernel")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the engine's Chrome-trace JSON here (Perfetto / "
                   "chrome://tracing)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write Prometheus text-exposition metrics here after the run")
    args = p.parse_args(argv)
    cfg = configure_kernel(
        get_config(args.arch, smoke=args.smoke), kernel=args.kernel,
        block=args.block, attn_kernel=args.attn_kernel,
    )
    params, masks, pack = init_serving_state(cfg, device=args.device)
    if args.lockstep:
        toks, stats = serve_session(cfg, params, batch=args.batch,
                                    prompt_len=args.prompt_len, gen=args.gen,
                                    masks=masks, pack=pack)
        print(f"lockstep  kernel={cfg.sparse.kernel}  "
              f"attn_kernel={cfg.sparse.attn_kernel}  generated shape: "
              f"{tuple(toks.shape)}  device={toks.device}")
        for k, v in stats.items():
            print(f"  {k}: {v:.4f}")
        return toks, stats
    obs = None
    if args.trace_out or args.metrics_out:
        obs = Observability(process_name="serve")
    engine = ServeEngine(
        cfg, params, capacity=args.capacity, max_len=args.max_len,
        masks=masks, pack=pack, queue_limit=args.queue_limit,
        deadline=args.deadline, max_retries=args.max_retries,
        paged=args.paged, page_size=args.page_size, n_blocks=args.n_blocks,
        prefix_cache=args.prefix_cache, obs=obs,
    )
    n_shed = sum(
        not engine.submit(r)
        for r in staggered_requests(cfg, args.requests,
                                    arrival_rate=args.arrival_rate)
    )
    if n_shed:
        print(f"backpressure: {n_shed} requests shed at submit "
              f"(--queue-limit {args.queue_limit})")
    stats = engine.run()
    if obs is not None:
        obs.flusher(metrics_path=args.metrics_out,
                    trace_path=args.trace_out).close(stats["wall_s"])
        for what, path in (("trace", args.trace_out), ("metrics", args.metrics_out)):
            if path:
                print(f"{what} written to {path}")
    print(f"engine  kernel={cfg.sparse.kernel}  "
          f"attn_kernel={cfg.sparse.attn_kernel}  capacity={args.capacity}  "
          f"paged={args.paged}  device={engine.device}")
    for k, v in stats.items():
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return stats


if __name__ == "__main__":
    main()
