"""Port serving engine vs the JAX engine on the same bridged state, plus the
port's import and device rules.

Greedy token streams must be IDENTICAL in f32: the same requests (made by
each package's ``staggered_requests`` from one seed), admitted into the same
slots, bucketed to the same padded lengths, decoded in the same number of
steps.  The eos case takes its eos id from the JAX engine's own stream, so
the port is held to the reference's function, not to a hand-written
expectation.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name, tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import init_serving_state, main  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models.model import init_lm  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(16, 16), kernel_block=(128, 16, 16),
              attn_kernel="flash_tight")
REQ = dict(prompt_lens=(5, 20, 9), gen_lens=(6, 3, 9, 4))
CAPACITY, MAX_LEN = 2, 32


@pytest.fixture(scope="module")
def engines_state():
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", sparse=SparseConfig(**SPARSE))
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", sparse=TSparse(**SPARSE))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, OptConfig())
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["params"]).items()}, "cpu")
    tm = bridge.masks_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(st["masks"]).items()}, tp, "cpu")
    tk = bridge.pack_from_flat(
        {path_name(p): e for p, e in flat_k if e is not None}, tp, "cpu")
    return (jcfg, st["params"], st["masks"], st["pack"]), (tcfg, tp, tm, tk)


def _drain(engine):
    """Virtual clock: every request arrives at t=0, admission order is the
    queue's, so both engines schedule identically."""
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


def _serve(Engine, side, reqs):
    cfg, params, masks, pack = side
    engine = Engine(cfg, params, capacity=CAPACITY, max_len=MAX_LEN,
                    masks=masks, pack=pack)
    for r in reqs:
        assert engine.submit(r)
    return engine, _drain(engine)


def test_engine_streams_match_jax(engines_state):
    jside, tside = engines_state
    jreqs = j_requests(jside[0], 5, **REQ)
    treqs = t_requests(tside[0], 5, **REQ)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.max_new_tokens == b.max_new_tokens
    je, js = _serve(JEngine, jside, jreqs)
    te, ts = _serve(TEngine, tside, treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert len({t for r in jreqs for t in r.generated}) > 3  # not degenerate
    assert all(r.status is Status.DONE for r in treqs)
    assert te.slot_history == je.slot_history
    for key in ("requests", "tokens", "decode_steps", "prefills", "quarantined"):
        assert ts[key] == js[key], key


def test_engine_eos_matches_jax(engines_state):
    """eos taken from the JAX engine's own greedy stream stops both engines
    at the same token (the eos itself kept); max_new_tokens=1 finishes from
    the prefill logits alone."""
    jside, tside = engines_state
    probe = j_requests(jside[0], 1, prompt_lens=(7,), gen_lens=(8,), seed=3)
    _serve(JEngine, jside, probe)
    stream = probe[0].generated
    cut = next((i for i in range(1, len(stream)) if stream[i] not in stream[:i]),
               None)
    assert cut is not None, f"degenerate stream {stream}"
    out = {}
    for name, Engine, side, make in (("jax", JEngine, jside, j_requests),
                                     ("port", TEngine, tside, t_requests)):
        reqs = make(side[0], 2, prompt_lens=(7,), gen_lens=(8, 1), seed=3)
        reqs[0].eos_id = stream[cut]
        reqs[1].tokens = reqs[0].tokens.copy()
        _serve(Engine, side, reqs)
        out[name] = [r.generated for r in reqs]
    assert out["port"] == out["jax"]
    assert out["port"][0] == stream[: cut + 1]
    assert out["port"][1] == stream[:1]


def test_engine_rejects_unported_features(engines_state):
    """Paged caches, the prefix cache and sampling are ported
    (tests/test_torch_paged.py, tests/test_torch_sampler.py), and so are
    the fault injector and observability (tests/test_torch_faults.py,
    tests/test_torch_obs.py): an engine takes both.  Patch prompts are
    ported (tests/test_torch_internvl.py): patches on a request to a
    config without a patch frontend are accepted and ignored, as the
    reference engine does with the same request (the same greedy stream
    as each other and as the request without patches)."""
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.serving.faults import FaultInjector

    _, (cfg, params, masks, pack) = engines_state
    obs = Observability(metrics=MetricsRegistry())
    faulty = TEngine(cfg, params, capacity=1, max_len=16, masks=masks, pack=pack,
                     faults=FaultInjector(), obs=obs)
    assert faulty.faults is not None and faulty.obs is obs
    assert obs.metrics.get("serve_requests_total") is not None
    jside, tside = engines_state
    streams = {}
    for name, Engine, side, make in (("jax", JEngine, jside, j_requests),
                                     ("port", TEngine, tside, t_requests)):
        reqs = make(side[0], 2, prompt_lens=(5,), gen_lens=(6,), seed=4)
        reqs[0].patches = np.zeros((1, 1), np.float32)
        reqs[1].tokens = reqs[0].tokens.copy()
        _serve(Engine, side, reqs)
        assert all(r.status.name == "DONE" for r in reqs), name
        streams[name] = [r.generated for r in reqs]
    assert streams["port"] == streams["jax"]
    assert streams["port"][0] == streams["port"][1]


def test_engine_quarantines_non_finite_slots(engines_state):
    """A non-finite forward quarantines the request: with one retry it is
    re-queued once, then FAILED; its slot is freed, nothing else breaks."""
    _, (cfg, params, masks, pack) = engines_state
    bad = dict(params, head={"w": params["head"]["w"].clone()})
    bad["head"]["w"][:, 3] = float("nan")
    engine = TEngine(cfg, bad, capacity=2, max_len=MAX_LEN, masks=masks,
                     pack=pack, max_retries=1)
    reqs = t_requests(cfg, 2, prompt_lens=(6,), gen_lens=(4,))
    for r in reqs:
        r.retry_backoff = 0.0
        engine.submit(r)
    stats = _drain(engine)
    assert all(r.status is Status.FAILED and "non-finite" in r.error for r in reqs)
    assert stats["failed"] == 2 and stats["retries"] == 2
    assert stats["quarantined"] == 4 and not engine.active.any()
    assert [q.where for q in engine.quarantine_log] == ["prefill"] * 4


def test_engine_sheds_at_the_queue_limit_and_deadline(engines_state):
    _, (cfg, params, masks, pack) = engines_state
    engine = TEngine(cfg, params, capacity=1, max_len=MAX_LEN, masks=masks,
                     pack=pack, queue_limit=2, deadline=1.0)
    reqs = t_requests(cfg, 3, prompt_lens=(6,), gen_lens=(2,))
    assert [engine.submit(r) for r in reqs] == [True, True, False]
    assert reqs[2].status is Status.SHED
    engine.step(now=0.0)  # request 0 runs to DONE, request 1 waits
    engine.step(now=5.0)  # past request 1's admission deadline: shed
    assert reqs[0].status is Status.DONE and reqs[1].status is Status.SHED
    assert engine.stats(5.0)["shed"] == 2


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port pulls in neither jax nor repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(SRC)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_need_a_card_or_device_cpu(monkeypatch):
    """Without a card, an entry point that was not given device='cpu'
    raises instead of running the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_get_config("h2o-danube-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_serving_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--requests", "1"])


def test_serve_cli_on_cpu(capsys):
    stats = main(["--smoke", "--device", "cpu", "--kernel", "block_sparse",
                  "--block", "16", "--attn-kernel", "flash_tight",
                  "--requests", "3", "--max-len", "64", "--capacity", "2"])
    assert stats["requests"] == 3 and stats["failed"] == 0
    assert "device=cpu" in capsys.readouterr().out
