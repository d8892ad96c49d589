"""FLOP accounting exactly as paper Appendix H: the port of the JAX
package's ``core/flops.py`` (plain numpy there too), on the port's own
``LayerSpec``, ``get_distribution`` and ``PruningSchedule``.

forward = sum over layers of 2 * (output elements) * (fan-in)  [mul+add],
backward = 2x forward.  Method costs per averaged step (per sample):

  Dense / Small-Dense : 3 * f_D
  Static / SNIP / SET : 3 * f_S
  SNFS                : 2 * f_S + f_D      (dense grads every step)
  RigL                : (3*f_S*dT + 2*f_S + f_D) / (dT + 1)
  Pruning             : E_t[ 3 * f_D * (1 - s_t) ]   (Zhu & Gupta ramp)

f_S is computed layer-by-layer from a sparsity distribution, which is what
makes ERK cost ~2x uniform (paper Fig 2-left).  The ResNet-50 layer table
below lets the test suite validate our accounting against the paper's
published multipliers (0.23x/0.10x train @ 80/90% uniform, 0.42x/0.24x ERK).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .distributions import LayerSpec, get_distribution
from .pruning import PruningSchedule

__all__ = [
    "ConvSpec",
    "DenseSpec",
    "layer_fwd_flops",
    "model_fwd_flops",
    "sparse_fwd_flops",
    "method_train_flops",
    "resnet50_layers",
    "lm_param_count",
]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kh: int
    kw: int
    cin: int
    cout: int
    hout: int
    wout: int
    dense: bool = False

    @property
    def weight_shape(self):
        return (self.kh, self.kw, self.cin, self.cout)

    @property
    def size(self):
        return self.kh * self.kw * self.cin * self.cout

    def fwd_flops(self) -> float:
        return 2.0 * self.hout * self.wout * self.size

    def layer_spec(self) -> LayerSpec:
        return LayerSpec(self.name, self.weight_shape, dense=self.dense)


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    name: str
    nin: int
    nout: int
    dense: bool = False

    @property
    def size(self):
        return self.nin * self.nout

    def fwd_flops(self) -> float:
        return 2.0 * self.size

    def layer_spec(self) -> LayerSpec:
        return LayerSpec(self.name, (self.nin, self.nout), dense=self.dense)


Layer = ConvSpec | DenseSpec


def layer_fwd_flops(layer: Layer, sparsity: float = 0.0) -> float:
    return layer.fwd_flops() * (1.0 - sparsity)


def model_fwd_flops(layers: Sequence[Layer]) -> float:
    return sum(l.fwd_flops() for l in layers)


def sparse_fwd_flops(
    layers: Sequence[Layer], sparsities: Mapping[str, float]
) -> float:
    return sum(layer_fwd_flops(l, sparsities.get(l.name, 0.0)) for l in layers)


def method_train_flops(
    method: str,
    f_dense: float,
    f_sparse: float,
    delta_t: int = 100,
    pruning_schedule: PruningSchedule | None = None,
    total_steps: int | None = None,
    f_sparse_bwd: float | None = None,
) -> float:
    """Average per-step per-sample training FLOPs (Appendix H).

    f_sparse_bwd: per-sample FLOPs of a backward pass at the Top-KAST
    superset density (k+Δ active) — defaults to f_sparse (Δ = 0).  Only
    'topkast' consumes it: fwd + dgrad run at forward density (2*f_sparse),
    wgrad at superset density, every step, no dense terms anywhere.
    """
    if method in ("dense", "small_dense"):
        return 3.0 * f_dense
    if method in ("static", "snip", "set"):
        return 3.0 * f_sparse
    if method == "topkast":
        return 2.0 * f_sparse + (
            f_sparse if f_sparse_bwd is None else f_sparse_bwd
        )
    if method == "snfs":
        return 2.0 * f_sparse + f_dense
    if method == "rigl":
        return (3.0 * f_sparse * delta_t + 2.0 * f_sparse + f_dense) / (delta_t + 1)
    if method == "pruning":
        assert pruning_schedule is not None and total_steps is not None
        ts = np.arange(total_steps)
        s_t = pruning_schedule.target(ts).numpy()
        return float(np.mean(3.0 * f_dense * (1.0 - s_t)))
    raise ValueError(method)


# --------------------------------------------------------------------------
# ResNet-50 (v1, 224x224) layer table — for validating against paper numbers.
# --------------------------------------------------------------------------

def resnet50_layers() -> list[Layer]:
    layers: list[Layer] = [ConvSpec("conv1", 7, 7, 3, 64, 112, 112)]
    stage_cfg = [  # (blocks, c_in_first, c_mid, c_out, spatial_out)
        (3, 64, 64, 256, 56),
        (4, 256, 128, 512, 28),
        (6, 512, 256, 1024, 14),
        (3, 1024, 512, 2048, 7),
    ]
    for si, (blocks, cin0, cmid, cout, hw) in enumerate(stage_cfg):
        cin = cin0
        for b in range(blocks):
            pre = f"s{si}b{b}"
            layers += [
                ConvSpec(f"{pre}_c1", 1, 1, cin, cmid, hw, hw),
                ConvSpec(f"{pre}_c2", 3, 3, cmid, cmid, hw, hw),
                ConvSpec(f"{pre}_c3", 1, 1, cmid, cout, hw, hw),
            ]
            if b == 0:
                layers.append(ConvSpec(f"{pre}_down", 1, 1, cin, cout, hw, hw))
            cin = cout
    layers.append(DenseSpec("fc", 2048, 1000))
    return layers


def resnet50_flop_multipliers(
    sparsity: float, distribution: str = "uniform", delta_t: int = 100
) -> dict[str, dict[str, float]]:
    """Reproduce paper Fig 2-left FLOPs columns analytically.

    Returns {method: {train: x, test: x}} normalized to dense.
    """
    layers = resnet50_layers()
    specs = [l.layer_spec() for l in layers]
    sp = get_distribution(distribution, specs, sparsity)
    f_d = model_fwd_flops(layers)
    f_s = sparse_fwd_flops(layers, sp)
    out = {}
    prune = PruningSchedule(sparsity, begin_step=8000, end_step=24000, prune_every=1000)
    for method in ("dense", "static", "snip", "set", "snfs", "rigl", "pruning"):
        train = method_train_flops(
            method, f_d, f_s, delta_t=delta_t, pruning_schedule=prune, total_steps=32000
        )
        test = f_d if method == "dense" else f_s
        out[method] = {
            "train": train / (3.0 * f_d),
            "test": test / f_d,
        }
    return out


# --------------------------------------------------------------------------
# LM analytic model FLOPs (roofline MODEL_FLOPS = 6*N*D; MoE uses N_active).
# --------------------------------------------------------------------------

def lm_param_count(cfg) -> dict[str, float]:
    """Analytic parameter counts from a ModelConfig (total + active)."""
    d = cfg.d_model
    hd = cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.block_type == "xlstm":
        # mLSTM qkv + out + gates (approximation documented in DESIGN.md)
        attn = 4 * d * d + 4 * d
    mlp_mult = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    ff = cfg.d_ff * d * mlp_mult if cfg.d_ff else 0
    moe_total = moe_active = 0.0
    if cfg.n_experts:
        per_exp = cfg.moe_d_ff * d * mlp_mult
        moe_total = cfg.n_experts * per_exp + cfg.n_shared_experts * per_exp
        moe_active = cfg.top_k * per_exp + cfg.n_shared_experts * per_exp
        ff = 0
    ssm = 0
    if cfg.block_type in ("hymba",):
        d_in = cfg.ssm_d_inner
        ssm = 2 * d * d_in + d_in * d + d_in * (2 * cfg.ssm_state + 2)
    per_layer = attn + ff + ssm
    embed = cfg.vocab_size * d
    total = cfg.n_layers * (per_layer + moe_total) + embed * (1 if cfg.tie_embeddings else 2)
    active = cfg.n_layers * (per_layer + moe_active) + embed * (1 if cfg.tie_embeddings else 2)
    return {"total": float(total), "active": float(active)}


def lm_model_flops(cfg, n_tokens: int, train: bool = True) -> float:
    """MODEL_FLOPS = 6 * N_active * D (2 fwd + 4 bwd per param per token)."""
    n = lm_param_count(cfg)["active"]
    mult = 6.0 if train else 2.0
    return mult * n * n_tokens
