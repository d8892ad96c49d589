"""Port of the paper's character-LM pieces vs the JAX package: the byte
corpus and its windows, the planted sparse teacher, and the §4.2 GRU LM.

``byte_corpus``/``text_batch`` are numpy on both sides, so they are held
bit for bit.  The teacher's draws are torch's in the port (not
``jax.random``'s): its function is held on the reference teacher's arrays
and the same inputs, its masks' density within sampling error of
``1 - sparsity``, and its batches for determinism in (seed, step).  The GRU
runs in f32 on both sides on weights carried over by the bridge; logits
and gradients agree within 1e-5 of the largest magnitude compared (the
same products summed in another order, through 12 recurrent steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.data import byte_corpus as j_byte_corpus  # noqa: E402
from repro.data import make_teacher as j_make_teacher  # noqa: E402
from repro.data import teacher_batch as j_teacher_batch  # noqa: E402
from repro.data import text_batch as j_text_batch  # noqa: E402
from repro.models.gru import gru_lm_apply as j_apply  # noqa: E402
from repro.models.gru import gru_lm_init as j_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.masks import tree_paths  # noqa: E402
from repro_torch.data.teacher import make_teacher, teacher_batch, teacher_targets  # noqa: E402
from repro_torch.data.text import byte_corpus, text_batch  # noqa: E402
from repro_torch.models.gru import gru_lm_apply, gru_lm_init  # noqa: E402

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: {err}"


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """A small explicit root: .py and .md files (and one ignored .txt)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i, ext in enumerate((".py", ".md", ".txt", ".py")):
        sub = root / f"d{i % 2}"
        sub.mkdir(exist_ok=True)
        body = rng.integers(32, 127, 4000 + 1000 * i).astype(np.uint8).tobytes()
        (sub / f"f{i}{ext}").write_bytes(body)
    return str(root)


def test_byte_corpus_and_windows_bit_for_bit(corpus_root):
    got, want = byte_corpus(corpus_root), j_byte_corpus(corpus_root)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    for step in (0, 1, 17):
        for split in ("train", "valid"):
            for seed in (23, 5):
                a = text_batch(step, 8, 96, corpus=got, seed=seed, split=split)
                b = j_text_batch(step, 8, 96, corpus=want, seed=seed, split=split)
                for k in ("tokens", "targets"):
                    assert a[k].dtype == b[k].dtype == np.int32
                    assert np.array_equal(a[k], b[k]), (step, split, seed, k)
    assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


def test_byte_corpus_too_small(tmp_path):
    (tmp_path / "a.py").write_bytes(b"x" * 100)
    with pytest.raises(ValueError, match="too small"):
        byte_corpus(str(tmp_path))


def test_teacher_function_matches_reference():
    """The reference teacher's arrays and its noise-free batch's x: the
    port's relu(x @ w1) @ w2 equals the reference's targets."""
    jt = j_make_teacher(jax.random.PRNGKey(3), sparsity=0.8)
    x, y = j_teacher_batch(jt, 4, batch=64, noise=0.0)
    tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
    _close(teacher_targets(tt, torch.from_numpy(np.array(x))), y, "targets")


def test_teacher_density_and_determinism():
    gen = torch.Generator().manual_seed(0)
    t = make_teacher(gen, d_in=64, d_hidden=256, d_out=32, sparsity=0.9)
    assert t["w1"].shape == (64, 256) and t["w2"].shape == (256, 32)
    for w in t.values():
        n = w.numel()
        dens = float((w != 0).float().mean())
        # 4 standard deviations of a Bernoulli(0.1) mean over n draws
        assert abs(dens - 0.1) <= 4 * np.sqrt(0.1 * 0.9 / n), dens
    x1, y1 = teacher_batch(t, 7, batch=32)
    x2, y2 = teacher_batch(t, 7, batch=32)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    x3, _ = teacher_batch(t, 8, batch=32)
    x4, _ = teacher_batch(t, 7, batch=32, seed=6)
    assert not torch.equal(x1, x3) and not torch.equal(x1, x4)
    # the noise is small beside the signal and centred on the function
    resid = y1 - teacher_targets(t, x1)
    assert 0.0 < float(resid.std()) < 0.02


def test_gru_init_layout_matches_reference():
    """The port's tree (paths, shapes, dtypes, sparse flags) is the
    reference's, so the bridge carries weights either way."""
    tp, tf = gru_lm_init(torch.Generator().manual_seed(0))
    jp, _, jf = j_init(jax.random.PRNGKey(0))
    got, want = tree_paths(tp), j_tree_paths(jp)
    assert sorted(got) == sorted(want)
    for n in want:
        assert tuple(got[n].shape) == tuple(want[n].shape), n
        assert got[n].dtype == torch.float32, n
    assert tree_paths(tf) == {n: bool(v) for n, v in j_tree_paths(jf).items()}
    assert tree_paths(tf)["gru/wh/w"] and not tree_paths(tf)["embed/table"]


def _xent(logits, tgt):
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.gather(-1, tgt[..., None])[..., 0]).mean()


def test_gru_logits_and_gradients_match_reference():
    """Reference weights, pre-masked at 75% (the paper's sparsity) as the
    char-LM benchmark feeds them, through the bridge: logits and the
    mean-xent gradients of every leaf."""
    jp, _, jf = j_init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    flat = {}
    for n, v in j_tree_paths(jp).items():
        v = np.asarray(v)
        if j_tree_paths(jf)[n]:
            v = v * (rng.random(v.shape) > 0.75)
        flat[n] = v.astype(np.float32)
    toks = rng.integers(0, 256, (3, 12)).astype(np.int32)
    tgt = rng.integers(0, 256, (3, 12)).astype(np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge._unflatten(flat))

    def jloss(p):
        lg = j_apply(p, jnp.asarray(toks))
        lse = jax.nn.logsumexp(lg, -1)
        return jnp.mean(lse - jnp.take_along_axis(lg, jnp.asarray(tgt)[..., None], -1)[..., 0])

    want_logits = j_apply(jparams, jnp.asarray(toks))
    want_grads = j_tree_paths(jax.grad(jloss)(jparams))
    tp = bridge.params_from_flat(flat, "cpu")
    leaves = tree_paths(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    logits = gru_lm_apply(tp, torch.from_numpy(toks))
    _close(logits, want_logits, "logits")
    grads = torch.autograd.grad(_xent(logits, torch.from_numpy(tgt).long()),
                                list(leaves.values()))
    for (n, _), g in zip(leaves.items(), grads):
        _close(g, want_grads[n], f"grad {n}")
