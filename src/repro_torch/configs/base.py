"""Model and sparsity configuration for the PyTorch port.

Own copies of ``SparseConfig``, ``validate_sparse_kernel`` and
``ModelConfig`` from the JAX package's ``configs/base.py``: the same fields
with the same defaults, so one configuration means the same model in both
packages and the parity tests can build both from one set of arguments.
The docstrings describe the reference's TPU execution paths; the port runs
every ``kernel`` value (hand-written CUDA kernels:
``kernels/block_sparse_matmul.py``, ``kernels/masked_matmul.py``), the fused
epilogue under ``kernel='masked'`` and every ``attn_kernel`` value (the
flash modes through ``kernels/flash_attention.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "SparseConfig", "validate_sparse_kernel"]


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """RigL settings attached to a model config (paper §3 + TPU execution).

    Topology / schedule (paper Algorithm 1):
      sparsity         target overall sparsity S in [0, 1) of the
                       sparsifiable weights (1 - density).
      distribution     how S is distributed across layers: 'uniform', 'er'
                       (Erdos-Renyi) or 'erk' (ER-kernel, paper default).
      method           'rigl' (grow by |dense grad|), 'set' (random grow),
                       'snfs' (grow by |dense momentum|), 'topkast' (forward
                       top-k, backward top-(k+Δ) superset — Jayakumar et al.;
                       always-sparse fwd AND bwd), 'static' (fixed topology).
                       Under kernel dispatch, rigl/snfs take their dense-side
                       grow scores from the Top-KAST backward superset
                       gradient instead of a dense backward (docs/training.md).
                       The drivers also accept 'snip' and 'pruning' via their
                       own code paths.
      backward_extra   Top-KAST superset breadth Δ as a fraction of each
                       layer's units (elements, or blocks in block mode):
                       |B| = min(total, |A| + ceil(backward_extra * total)).
                       Consumed whenever the state carries backward masks —
                       method='topkast', or rigl/snfs under a sparse kernel.
      delta_t          steps between topology updates (drop/grow cadence);
                       also the amortization window for every host-side
                       topology cost (dense backward, PackState repack).
      alpha            initial drop/grow fraction, cosine-annealed to 0.
      t_end_fraction   updates stop after this fraction of total steps.
      grow_init        init for grown connections: 'zeros' (paper default,
                       function-preserving), 'random', or 'gradient'.
      block_shape      (bk, bn) or None.  When set, drop/grow scores are
                       L1-pooled over aligned weight blocks (core/rigl.py), so
                       every mask stays block-aligned — REQUIRED for
                       kernel='block_sparse', where it must equal the kernel's
                       (bk, bn) tiles (validate_sparse_kernel enforces this).

    Execution path for sparsifiable matmuls (models/layers.py dispatch; the
    full path is documented in docs/kernels.md):
      kernel           'dense'        x @ (w*m); XLA materializes w*m in HBM
                                      (reference semantics, no Pallas).
                       'masked'       Pallas fused-mask matmul: any mask
                                      pattern; w*m only ever exists tile-wise
                                      in VMEM.
                       'block_sparse' Pallas block-skipping matmul: inactive
                                      (bk x bn) blocks are skipped entirely —
                                      HBM traffic and MXU work scale with
                                      block density in fwd AND bwd.  The
                                      train/serve state then carries a
                                      PackState (core/pack.py) so kernel
                                      grids are sized to the true
                                      active-block count (tight grids).
                       Both Pallas paths carry custom-VJP backward kernels
                       (kernels/masked_matmul.py, block_sparse_matmul.py).
      kernel_block     (bm, bn, bk) Pallas tile sizes: bm rows of the
                       flattened batch*seq dim, bn output columns, bk
                       contraction rows.  128-aligned tiles target TPU v5e;
                       for kernel='block_sparse', (bk, bn) doubles as the
                       weight-block granularity and must match block_shape.
      pack_width_slack width hysteresis for PackState refreshes (core/pack.py):
                       packed widths are rounded UP to the next multiple of
                       ``ceil(slack * worst_case_width)`` (and never shrink),
                       so drifting topologies re-trace the jitted step only
                       when a width crosses a slack step instead of on every
                       1-wide wiggle.  0.0 (default) keeps exact tight widths;
                       grouped banks benefit most (one lopsided expert widens
                       the whole bank's shared width).
      fused_epilogue   fuse the SGD grad-accum epilogue into the wgrad
                       kernels (docs/kernels.md#fused-epilogue): the weight
                       cotangent leaving the backward IS the new momentum
                       m_new = mu*mom + dw + wd*w, so the raw gradient never
                       round-trips HBM.  Requires kernel dispatch + plain SGD
                       (no nesterov/grad_clip, microbatches=1, method !=
                       'snfs', bf16_grads off) — training/steps.py raises
                       loudly on unsupported combinations.  With
                       OptConfig.state_dtype='bfloat16' the kernel also
                       stochastically rounds m_new onto the bf16 grid.

    Execution path for ATTENTION score blocks (independent of the weight
    kernels above; models/attention.py dispatch):
      attn_kernel      'dense'        pure-jnp chunked attention — scores
                                      materialize in HBM (reference path).
                       'flash'        Pallas flash attention, fwd + custom-VJP
                                      bwd, PADDED grid: the KV loop spans the
                                      full Sk/bk range with dead score blocks
                                      guarded off (baseline for parity).
                       'flash_tight'  same kernels on a host-built
                                      AttnSchedule (core/attn_sched.py): the
                                      grid walks only LIVE KV blocks per
                                      q-row, so causal/sliding-window layers
                                      skip dead blocks' DMA and iterations —
                                      the attention twin of tight PackState
                                      grids.
    """

    sparsity: float = 0.8
    distribution: str = "erk"  # uniform | er | erk
    method: str = "rigl"  # rigl | set | snfs | topkast | static
    backward_extra: float = 0.1  # Top-KAST superset Δ fraction
    delta_t: int = 100
    alpha: float = 0.3
    t_end_fraction: float = 0.75
    grow_init: str = "zeros"
    block_shape: Optional[tuple[int, int]] = None  # TPU block-sparse mode
    kernel: str = "dense"
    kernel_block: tuple[int, int, int] = (128, 128, 128)  # (bm, bn, bk) tiles
    pack_width_slack: float = 0.0  # width hysteresis (0 = exact tight widths)
    fused_epilogue: bool = False  # fuse SGD epilogue into the wgrad kernels
    attn_kernel: str = "dense"  # dense | flash | flash_tight


def validate_sparse_kernel(sp: SparseConfig) -> None:
    """Fail fast on inconsistent kernel-dispatch settings.

    block_sparse executes whole (bk x bn) weight blocks unmasked inside active
    blocks, so the elementwise mask MUST be block-aligned — which core.rigl
    guarantees exactly when block_shape matches the kernel's (bk, bn).
    """
    if sp.kernel not in ("dense", "masked", "block_sparse"):
        raise ValueError(f"unknown sparse.kernel {sp.kernel!r}")
    if getattr(sp, "attn_kernel", "dense") not in (
        "dense", "flash", "flash_tight"
    ):
        raise ValueError(f"unknown sparse.attn_kernel {sp.attn_kernel!r}")
    if not 0.0 <= getattr(sp, "backward_extra", 0.1) <= 1.0:
        raise ValueError(
            f"sparse.backward_extra must be in [0, 1] "
            f"(got {sp.backward_extra!r})"
        )
    if not 0.0 <= getattr(sp, "pack_width_slack", 0.0) <= 1.0:
        raise ValueError(
            f"sparse.pack_width_slack must be in [0, 1] "
            f"(got {sp.pack_width_slack!r})"
        )
    if getattr(sp, "fused_epilogue", False) and sp.kernel not in (
        "masked", "block_sparse"
    ):
        raise ValueError(
            "sparse.fused_epilogue fuses the optimizer epilogue into the "
            "Pallas wgrad kernels — it requires kernel='masked' or "
            f"'block_sparse' (got kernel={sp.kernel!r})"
        )
    if sp.kernel == "block_sparse":
        _, bn, bk = sp.kernel_block
        if sp.block_shape is None or tuple(sp.block_shape) != (bk, bn):
            raise ValueError(
                "sparse.kernel='block_sparse' needs block-aligned masks: set "
                f"sparse.block_shape=({bk}, {bn}) to match kernel_block "
                f"(got {sp.block_shape})"
            )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    block_type: str = "transformer"  # transformer | xlstm | hymba
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 256
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu | none
    # attention pattern: cycle of 'global'/'local' applied per layer index,
    # plus optional explicit global layer ids (hymba: first/middle/last).
    attn_pattern: tuple[str, ...] = ("global",)
    global_layer_ids: tuple[int, ...] = ()
    window: int = 0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1e4
    causal: bool = True  # False => encoder-only (hubert)
    parallel_block: bool = False  # command-r style attn || mlp
    post_norms: bool = False  # gemma-style sandwich norms
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / xLSTM
    ssm_state: int = 0
    ssm_d_inner: int = 0
    slstm_every: int = 0  # xlstm: layer i is sLSTM if i % slstm_every == slstm_every-1
    # frontend stubs (vlm/audio): precomputed embeddings come in via input_specs
    frontend: str = "none"  # none | patch | frames
    frontend_dim: int = 0
    n_patches: int = 0
    # io / numerics
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    q_chunk: int = 4096
    loss_chunks: int = 1  # chunk the vocab-parallel xent over seq
    remat: bool = True
    remat_group: int = 1  # layers per checkpoint region (sqrt-style remat)
    remat_policy: str = "none"  # none | dots (save matmul outputs)
    bf16_grads: bool = False  # cast w_eff once -> bf16 grads & DP all-reduce
    attn_scores_dtype: str = "float32"  # bfloat16 halves score HBM traffic
    microbatches: int = 1  # gradient-accumulation chunks per step
    scan_microbatches: bool = False  # lax.scan over microbatches (small HLO)
    grad_accum_dtype: str = "float32"
    seq_shard_activations: bool = False  # Megatron-style sequence parallelism
    scan_layers: bool = False  # set by dryrun for the full-depth memory proof
    fsdp: bool = False  # shard weight embed-dims over the data axis
    sparse: SparseConfig = SparseConfig()

    def layer_kind(self, i: int) -> str:
        """'global' or 'local' attention for layer i."""
        if self.global_layer_ids:
            return "global" if i in self.global_layer_ids else "local"
        return self.attn_pattern[i % len(self.attn_pattern)]

    def is_slstm(self, i: int) -> bool:
        return self.slstm_every > 0 and (i % self.slstm_every == self.slstm_every - 1)

    @property
    def pattern_period(self) -> int:
        """Smallest repeating super-block (for cost extrapolation)."""
        if self.block_type == "xlstm" and self.slstm_every:
            return self.slstm_every
        if self.global_layer_ids:
            return 1  # irregular: treated per-layer (costed with local kind)
        return len(self.attn_pattern)
