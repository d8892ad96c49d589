"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it runs on a machine that has
only PyTorch:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pack import pack_np  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ops import block_sparse_linear  # noqa: E402

FLASH_CASES = {
    # name: (Sq, Sk, causal, window, softcap, kv_groups)
    "causal": (256, 256, True, 0, 0.0, 1),
    "window": (300, 300, True, 64, 0.0, 4),
    "ragged": (100, 100, True, 0, 0.0, 4),
    "softcap": (256, 256, True, 0, 30.0, 4),
    "q_offset": (64, 200, True, 0, 0.0, 2),
    "full": (128, 128, False, 0, 0.0, 1),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 384, 128), (200, 512, 256, 128),
                                   (16, 96, 64, 16), (40, 64, 160, 32)])
def test_cuda_block_sparse_matches_plain(shape):
    """Both accumulate in f32 and round once to bf16: one bf16 ulp apart at
    most (2**-7 of the largest output)."""
    dev = _cuda()
    M, K, N, blk = shape
    rng = np.random.default_rng(5)
    bm = rng.random((K // blk, N // blk)) < 0.5
    bm[:, 0] = False
    dense = np.repeat(np.repeat(bm, blk, 0), blk, 1)
    w = torch.from_numpy((rng.standard_normal((K, N)) * dense).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    idx, cnt = (torch.from_numpy(a) for a in pack_np(bm))
    args = (x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16))
    block = (128, blk, blk)
    got = block_sparse_linear(*args, pack=(idx.to(dev), cnt.to(dev)), block=block)
    want = block_sparse_linear(*(a.cpu() for a in args), pack=(idx, cnt), block=block)
    assert not got[:, :blk].float().abs().any()  # the empty column
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_matches_plain(case):
    dev = _cuda()
    Sq, Sk, causal, window, softcap, G = FLASH_CASES[case]
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, 80)).astype(np.float32))
               .to(torch.bfloat16) for n, s in ((8, Sq), (8 // G, Sk), (8 // G, Sk)))
    # o, element by element: the bound of rounding p to bf16 in the kernel
    # and o to bf16 on both sides (tfa.o_error_bound); lse: f32 in both
    kw = dict(causal=causal, window=window, softcap=softcap, kv_groups=G,
              return_lse=True)
    o, lse = tfa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    po, plse = tfa.flash_attention(q, k, v, **kw)
    pa, _ = tfa.flash_attention(q, k, v.abs(), **kw)
    assert bool(((o.float().cpu() - po.float()).abs() <= tfa.o_error_bound(po, pa)).all())
    assert (lse.cpu() - plse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor the kernel does not take raises; nothing falls back to
    the plain version."""
    dev = _cuda()
    x = torch.zeros(16, 128, device=dev)  # f32
    idx = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    cnt = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        block_sparse_linear(x, torch.zeros(128, 128, device=dev), pack=(idx, cnt))
    q = torch.zeros(2, 32, 80, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_attention(q, q, q)
