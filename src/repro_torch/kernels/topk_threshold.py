"""The 512-bin histogram of |x| behind the k-th-magnitude threshold (K21).

Replaces the TPU kernel ``repro/kernels/topk_threshold.py::_kernel``
(``pallas_call`` in ``histogram_abs``) with a hand-written CUDA kernel for
Hopper (sm_90a) in csrc/topk_threshold.cu (the design and its bound are
described there): one streaming pass over x counts |x| into 512 equal bins
over [0, hi).  ``kernels/ops.py::topk_threshold`` turns the histogram into
the threshold.

``histogram_counts`` launches K21 for CUDA tensors and runs the plain
PyTorch version ``histogram_counts_plain`` only for CPU tensors;
``launches`` counts kernel launches.  Both compute each element's bin with
the reference's f32 formula, ``int(clip(|x| / hi, 0, 1 - 1e-7) * 512)``, a
NaN going to bin 0 as in the reference's CPU run, and return the exact
int64 counts.  ``histogram_abs`` (and ``histogram_abs_plain``) is the
reference's contract: the counts as a (1, 512) f32 histogram, rounded
once, so a bin is exact below 2**24 (the reference's f32 sums of tile
counts are exact only there).  ``kth_value_plain`` is the exact k-th
largest |x| (the reference's ``ref.py::kth_value_ref``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["N_BINS", "histogram_abs", "histogram_abs_plain", "histogram_counts",
           "histogram_counts_plain", "kth_value_plain", "launches"]

N_BINS = 512
TOP = np.float32(1.0 - 1e-7)  # the f32 rounding of the reference's 1 - 1e-7

launches = 0  # K21 launches since import (or since a caller reset them)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p


def _limit(hi, device) -> torch.Tensor:
    return torch.as_tensor(hi, dtype=torch.float32, device=device).reshape(1)


def histogram_counts_plain(x: torch.Tensor, hi) -> torch.Tensor:
    """(512,) int64 counts of |x| over [0, hi): the reference's bins
    (``ref.py::histogram_abs_ref``, with a NaN in bin 0 as the reference
    kernel's CPU run puts it) through ``torch.bincount``."""
    a = x.reshape(-1).float().abs()
    s = torch.fmin(torch.fmax(a / _limit(hi, x.device), torch.zeros((), device=x.device)),
                   torch.tensor(TOP, device=x.device))
    bins = (s * N_BINS).to(torch.int64)  # s >= 0: truncation is the floor
    return torch.bincount(bins, minlength=N_BINS)


def histogram_counts(x: torch.Tensor, hi) -> torch.Tensor:
    """K21: (512,) int64 counts of |x| over [0, hi) for x of any shape, f32
    or bf16; ``hi`` a float or an f32 tensor (read on the device, no host
    sync).  CUDA tensors run the kernel or raise; CPU tensors run the plain
    version."""
    global launches
    if x.device.type == "cpu":
        return histogram_counts_plain(x, hi)
    if x.device.type != "cuda":
        raise TypeError(f"histogram_counts: x on {x.device}: the kernel takes CUDA tensors")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"histogram_counts: the CUDA kernel takes f32 or bf16 (got {x.dtype})")
    flat = x.reshape(-1)
    if not flat.is_contiguous() or flat.data_ptr() % 16:
        flat = flat.clone()  # a fresh allocation: contiguous and 16-byte aligned
    lim = _limit(hi, x.device)
    out = torch.zeros(N_BINS, dtype=torch.int64, device=x.device)
    lib = _build.load("topk_threshold")
    fn = getattr(lib, f"histogram_abs_{_SUFFIX[x.dtype]}")
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    n = flat.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # 4 CTAs an SM, or fewer when n is small (256 threads x 16 bytes a step)
    n_ctas = max(1, min(4 * sms, -(-n * flat.element_size() // (256 * 16))))
    with torch.cuda.device(x.device):
        rc = fn(flat.data_ptr(), n, lim.data_ptr(), out.data_ptr(), n_ctas,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "histogram_abs launch")
    launches += 1
    return out


def histogram_abs_plain(x: torch.Tensor, hi) -> torch.Tensor:
    """The plain version's counts as the reference's (1, 512) f32
    histogram."""
    return histogram_counts_plain(x, hi).to(torch.float32)[None, :]


def histogram_abs(x: torch.Tensor, hi) -> torch.Tensor:
    """(1, 512) f32 histogram of |x| over [0, hi): K21's counts
    (``histogram_counts``) rounded once to f32, the reference's
    ``histogram_abs`` contract."""
    return histogram_counts(x, hi).to(torch.float32)[None, :]


def kth_value_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest |x| in f32 (the threshold RigL's drop needs)."""
    return torch.sort(x.reshape(-1).float().abs(), descending=True).values[k - 1]
