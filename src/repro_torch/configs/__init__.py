"""Config registry of the port: ``get_config(arch_id, smoke=False)``.

Every architecture of the JAX package is ported: the ten configs, each a
copy of the reference's ``CONFIG`` and ``SMOKE``.  An unknown name raises.
"""
import importlib

from .base import ModelConfig, SparseConfig, validate_sparse_kernel

__all__ = ["ModelConfig", "SparseConfig", "validate_sparse_kernel",
           "get_config", "ARCH_IDS"]

_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "hymba-1.5b": "hymba_1_5b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma3-4b": "gemma3_4b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "grok-1-314b": "grok_1_314b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise NotImplementedError(
            f"unknown architecture {arch!r} (the PyTorch port runs "
            f"{', '.join(ARCH_IDS)})"
        )
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
