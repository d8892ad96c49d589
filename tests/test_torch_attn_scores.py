"""The ``attn_scores_dtype='bfloat16'`` setting of the port's dense attention
path against the JAX package (the reference's ``models/attention.py::
_scores`` and ``_attend_block``), on h2o-danube-1.8b's smoke config in
bf16 with no sparsity: prefill and decode logits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_prefill as j_lm_prefill  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402


def _close(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |port - jax| = {err} > {bound}"


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attn_scores_bf16_matches_reference(softcap):
    """``attn_scores_dtype='bfloat16'`` on the dense attention path (bf16
    config, danube SMOKE, no sparsity): the scores are the f32-accumulated
    product rounded to bf16, the softcap, mask and softmax run in bf16 op by
    op as the reference's ``_attend_block``.  The prefill logits and one
    decode step's hold within 1e-4 of the largest logit (measured ~4e-7 of
    it against the reference run op by op); computing the scores in f32, as
    the port did, misses by ~1e-2 of it."""
    sp = dict(sparsity=0.0, kernel="dense", attn_kernel="dense")
    kw = dict(dtype="bfloat16", attn_scores_dtype="bfloat16", logit_softcap=softcap)
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               sparse=SparseConfig(**sp), **kw)
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**sp), **kw)
    jp, _, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_flat({n: np.asarray(v) for n, v in j_tree_paths(jp).items()},
                                 "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    # eager, op by op: under jit XLA keeps some fused bf16 intermediates in
    # f32, which moves the reference's own logits by 1.2e-2 to 1.6e-2 (0.5%
    # to 0.6% of the largest)
    jl, jc = j_lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 48)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jd, _ = j_lm_decode(jp, jcfg, jc, jnp.asarray(nxt), 40)
    with torch.no_grad():
        tl, tc = tm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, 48)
        td, _ = tm.lm_decode(tp, tcfg, tc, torch.from_numpy(nxt).long(), 40)
    V = jcfg.vocab_size
    for got, want, what in ((tl, jl, "prefill"), (td, jd, "decode")):
        _close(got[..., :V], np.asarray(want, np.float32)[..., :V], 1e-4, what)
