"""Port sampler vs ``jax.random`` and the JAX package's sampler.

The port computes threefry-2x32 in torch integer arithmetic; its keys and
raw bits must equal ``jax.random``'s bit for bit (``PRNGKey``, ``fold_in``
and ``random_bits`` with partitionable counters, the installed JAX's
default), and ``sample_tokens`` must pick the reference's token on the same
logits and keys.  The gumbel noise is compared to 1e-6 relative: both take
-log(-log(u)) of the same u, and the two libraries' f32 log may round
differently in the last bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import sampler as JS  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.serving import sampler as TS  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402

SEEDS = [0, 1, 7, 2**31 - 1, 2**31, 2**32 + 5, -1]
GEN = [0, 1, 2, 31, 1000, 2**31 - 1]


def test_threefry_is_jax_threefry2x32():
    """The raw hash against JAX's primitive on random keys and counters."""
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32)
    cnt = rng.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32)
    for key, c in zip(keys, cnt):
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(c)))
        k = torch.from_numpy(key.astype(np.int64))
        x = torch.from_numpy(c.astype(np.int64))
        y0, y1 = TS.threefry2x32(k[0], k[1], x[0], x[1])
        assert [int(y0), int(y1)] == want.tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_request_key_is_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = TS.request_key(seed)
    assert got.dtype == np.uint32 and got.tolist() == want.tolist()


def test_step_keys_are_fold_in():
    base = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS[:len(GEN)]])
    gen = np.asarray(GEN, np.int32)
    want = np.asarray(JS.step_keys(jnp.asarray(base), jnp.asarray(gen)))
    got = TS.step_keys(torch.from_numpy(base.astype(np.int64)), torch.from_numpy(gen))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 5, 128, 32768])
def test_random_bits_and_gumbel_match_jax(n):
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), g))
                     for s, g in ((0, 0), (2**31 - 1, 3), (12345, 2**31 - 1))])
    tk = torch.from_numpy(keys.astype(np.int64))
    bits = TS.random_bits(tk, n).numpy()
    gum = TS._gumbel(tk, n).numpy()
    for i, key in enumerate(keys):
        want = np.asarray(jax.random.bits(jnp.asarray(key), (n,), jnp.uint32))
        np.testing.assert_array_equal(bits[i], want.astype(np.int64))
        g = np.asarray(jax.random.gumbel(jnp.asarray(key), (n,), jnp.float32))
        np.testing.assert_allclose(gum[i], g, rtol=1e-6, atol=1e-6)


def _logits(seed, B, V, ties: bool):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32) * 3
    if ties:  # quantized: many logits tie, also at the k-th largest
        x = np.round(x)
    return x


@pytest.mark.parametrize("ties", [False, True])
def test_sample_tokens_match_reference(ties):
    """Rows mix greedy (temperature 0 and negative), plain temperature,
    top-k 1/5/40 and top-k larger than the vocabulary; many keys per row
    so that every branch draws."""
    B, V = 8, 256
    temp = np.array([0.0, -1.0, 0.7, 1.0, 1.3, 0.5, 2.0, 0.9], np.float32)
    topk = np.array([0, 5, 0, 1, 5, 40, 300, 3], np.int32)
    for trial in range(6):
        logits = _logits(trial, B, V, ties)
        base = np.stack([np.asarray(jax.random.PRNGKey(100 * trial + b)) for b in range(B)])
        gen = np.arange(B, dtype=np.int32) * 17 + trial
        jk = JS.step_keys(jnp.asarray(base), jnp.asarray(gen))
        want = np.asarray(JS.sample_tokens(jnp.asarray(logits), jk,
                                           jnp.asarray(temp), jnp.asarray(topk)))
        tk = TS.step_keys(torch.from_numpy(base.astype(np.int64)), torch.from_numpy(gen))
        got = TS.sample_tokens(torch.from_numpy(logits), tk, torch.from_numpy(temp),
                               torch.from_numpy(topk))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(got.numpy()[:2], logits[:2].argmax(-1))


SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(16, 16), kernel_block=(128, 16, 16),
              attn_kernel="flash_tight")


def test_sampled_engine_stream_matches_reference():
    """Temperature and top-k requests next to greedy ones, through both
    engines on the same bridged f32 state: identical token streams."""
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", sparse=SparseConfig(**SPARSE))
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", sparse=TSparse(**SPARSE))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    tmask = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu")
    tpack = bridge.pack_from_flat(
        {path_name(p): e for p, e in flat_k if e is not None}, tp, "cpu")
    kw = dict(prompt_lens=(5, 9), gen_lens=(8, 5, 7))
    streams = {}
    for name, Engine, make, state in (
            ("jax", JEngine, j_requests, (jcfg, st["params"], st["masks"], st["pack"])),
            ("port", TEngine, t_requests, (tcfg, tp, tmask, tpack))):
        cfg, params, masks, pack = state
        reqs = make(cfg, 5, temperature=0.9, top_k=20, **kw)
        reqs[1].temperature = 0.0  # a greedy request among sampled ones
        reqs[3].top_k = 0
        eng = Engine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack)
        for r in reqs:
            eng.submit(r)
        while len(eng.queue) or eng.active.any():
            eng.step(now=0.0)
        streams[name] = [r.generated for r in reqs]
    assert streams["port"] == streams["jax"]
    assert len({t for s in streams["port"] for t in s}) > 5
