"""The port's observability layer (``repro_torch/obs``) against the JAX
package's ``repro/obs``, and its instrumentation of the engine, the train
loop and both CLIs.

The registry, tracer and exporters are a copy: the same call sequence on
both packages gives equal snapshots, byte-identical Prometheus text, equal
Chrome events and the same flushes.  The engine under a virtual clock
(every timestamp a caller's ``now``) on the same bridged weights and
requests emits the reference engine's metric catalog, counts and trace
events; the one series that differs by design is ``serve_retraces`` (the
reference counts jit compiles, the port the launch plans it builds).
"""
import dataclasses
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.serving import FaultInjector as JInjector  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import burst_storm as j_storm  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.faults import FaultInjector as TInjector  # noqa: E402
from repro_torch.serving.faults import burst_storm as t_storm  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# the obs copy: the same call sequence, the same artefacts
# ---------------------------------------------------------------------------


def _drive(obs_mod, tmp: Path, scenario: str):
    """One call sequence on ``obs_mod`` -> everything it produced."""
    reg = obs_mod.MetricsRegistry()
    tr = obs_mod.SpanTracer(capacity=4 if scenario == "ring" else 64, pid=2,
                            process_name="serve")
    tr.thread_name(0, "engine")
    tr.thread_name(0, "renamed")  # first name wins
    c = reg.counter("reqs_total", "terminal requests", labels=("status",))
    c.labels("DONE").inc(7)
    c.labels('weird "quoted"\nvalue').inc()
    reg.gauge("occupancy", "slots").set(3)
    reg.gauge("ratio").set(0.1 + 0.2)
    reg.gauge("edge").set(-math.inf)
    h = reg.histogram("wait_seconds", "queue wait",
                      buckets=obs_mod.exponential_buckets(0.05, 4.0, 3))
    for v in (0.01, 0.05, 0.5, 30.0, 0.2):
        h.observe(v)
    reg.histogram("step_seconds").observe(1e-3)  # the default ladder
    for i in range(10):
        tr.span("prefill", 0.5 * i, 0.5 * i + 0.25, tid=1, cat="serve",
                args={"rid": i})
        tr.instant("quarantine", 0.3 * i, tid=2, cat="chaos")
        tr.counter("occupancy", 0.1 * i, {"active": i % 3})
    tr.span("clamped", 2.0, 1.0)
    fl = obs_mod.PeriodicFlusher(
        registry=reg, tracer=tr, metrics_path=tmp / "m.prom",
        trace_path=tmp / "t.json", events_path=tmp / "e.jsonl",
        interval=5.0 if scenario != "flush_every_call" else 0.0)
    flushes = [fl.maybe_flush(t) for t in (0.0, 3.0, 6.0, 6.5, 11.0)]
    tr.instant("late", 12.0)
    fl.close(12.0)
    snap = reg.snapshot()
    text = obs_mod.prometheus_text(snap)
    return {
        "snapshot": snap, "text": text,
        "parsed": obs_mod.parse_prometheus_text(text),
        "events": tr.chrome_events(), "n_emitted": tr.n_emitted,
        "n_dropped": tr.n_dropped, "find": tr.find("quarantine"),
        "flushes": flushes, "n_flushes": fl.n_flushes,
        "files": {n: (tmp / n).read_text() for n in ("m.prom", "t.json", "e.jsonl")},
        "stats": (obs_mod.percentile([], 50), obs_mod.summarize([3.0, 1.0, 2.0]),
                  obs_mod.median_by([{"k": 2}, {"k": 1}], "k")),
    }


@pytest.mark.parametrize("scenario", ["default", "ring", "flush_every_call"])
def test_obs_copy_matches_reference(tmp_path, scenario):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _drive(jobs, tmp_path / "j", scenario)
    got = _drive(tobs, tmp_path / "t", scenario)
    assert got["text"] == want["text"]  # byte-identical exposition
    for key in want:
        assert got[key] == want[key], key
    # the round trip holds exactly and the trace loads as Chrome JSON
    assert got["parsed"]["ratio"][frozenset()] == 0.1 + 0.2
    doc = json.loads(got["files"]["t.json"])
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"][0]["ph"] == "M"
    if scenario == "ring":
        assert got["n_dropped"] == got["n_emitted"] - 4


def test_registry_errors_match_reference():
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        with pytest.raises(ValueError, match="negative"):
            reg.get("x_total").inc(-1)
        with pytest.raises(ValueError):
            mod.Histogram(bounds=(1.0, 1.0))


def test_jit_retraces_counts_lru_misses():
    """The port's ``jit_retraces`` counts ``cache_info().misses`` of the
    lru-cached builders it is given, the reference's rule for its lru
    wrappers; the port's plan caches are among them."""
    import functools

    @functools.lru_cache(maxsize=None)
    def f(x):
        return x

    f(1), f(1), f(2)
    assert tobs.jit_retraces(f, object()) == jobs.jit_retraces(f) == 2
    caches = tobs.kernels_plan_caches()
    assert caches and all(hasattr(c, "cache_info") for c in caches)


# ---------------------------------------------------------------------------
# the engine: the reference's catalog and counts under a virtual clock
# ---------------------------------------------------------------------------


def _cfgs():
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp, _, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_flat(
        {n: np.asarray(v) for n, v in j_tree_paths(jp).items()}, "cpu")
    return (jcfg, jp), (tcfg, tp)


def _drain(engine, dt=1.0):
    now = 0.0
    for _ in range(2000):
        if not (len(engine.queue) or engine.active.any()):
            return now
        engine.step(now)
        now += dt
    raise AssertionError("engine failed to drain")


def _injector(Inj):
    # capacity 3, a burst of 7: rids 0-2 hold slots 0-2 at step 2; rid 5's
    # every prefill is poisoned (one retry, then FAILED)
    return Inj(seed=0).poison_logits(2, 0).poison_logits(4, 1, float("inf")) \
        .poison_prefill(5)


def _run(side, Engine, Obs, Reg, storm, Inj=None, **kw):
    cfg, params = side
    obs = None if Obs is None else Obs(metrics=Reg(), process_name="serve")
    eng = Engine(cfg, params, capacity=3, max_len=32, obs=obs,
                 faults=None if Inj is None else _injector(Inj), max_retries=1,
                 **kw)
    for r in storm(cfg, 7, prompt_len=8, max_new_tokens=6):
        eng.submit(r)
    _drain(eng)
    # either package's Status: compared by value
    streams = {r.rid: list(r.generated) for r in eng.queue.done
               if r.status.value == Status.DONE.value}
    return obs, eng, streams


@pytest.fixture(scope="module")
def chaos_runs(weights):
    jside, tside = weights
    j = _run(jside, JEngine, jobs.Observability, jobs.MetricsRegistry, j_storm, JInjector)
    t = _run(tside, TEngine, tobs.Observability, tobs.MetricsRegistry, t_storm, TInjector)
    return j, t


def _without_retraces(snap):
    snap = dict(snap)
    r = snap.pop("serve_retraces")
    return snap, (r["kind"], r["labelnames"])


def test_engine_metrics_and_trace_match_reference(chaos_runs):
    (jo, je, js), (to, te, ts) = chaos_runs
    want, want_r = _without_retraces(jo.metrics.snapshot())
    got, got_r = _without_retraces(to.metrics.snapshot())
    assert got_r == want_r == ("gauge", [])
    # names, kinds, labels, helps and every count (requests by status,
    # tokens, decode steps, prefills by variant, quarantines by phase,
    # retries, the histograms under the virtual clock)
    assert got == want
    done = got["serve_requests_total"]["series"]
    assert {s["labels"]["status"]: s["value"] for s in done} == {
        "DONE": 6.0, "SHED": 0.0, "FAILED": 1.0}
    quar = {s["labels"]["where"]: s["value"]
            for s in got["serve_quarantine_total"]["series"]}
    assert quar == {"decode": 2.0, "prefill": 2.0}
    assert to.trace.chrome_events() == jo.trace.chrome_events()
    assert te.quarantine_log == je.quarantine_log
    assert ts == js and sorted(ts) == [0, 1, 2, 3, 4, 6]
    assert te.stats(0.0)["n_retraces"] == 0  # no plan built on the CPU


def test_engine_trace_joins_quarantine_log_and_injector(chaos_runs):
    _, (obs, eng, _) = chaos_runs
    quar = obs.trace.find("quarantine")
    assert [(e["args"]["step"], e["args"]["rid"], e["args"]["slot"],
             e["args"]["attempt"], e["args"]["where"]) for e in quar] == [
        tuple(q) for q in eng.quarantine_log]
    assert all(e["tid"] == e["args"]["slot"] + 1 for e in quar)
    fired = obs.trace.find("fault_injected")
    log = eng.faults.log
    assert [(e["args"]["step"], tuple(e["args"]["targeted"])) for e in fired] == [
        (k, plan) for kind, k, plan in (x[:3] for x in log) if kind == "decode"]
    hit = {(a["rid"], a["attempt"]) for e in fired for a in e["args"]["active"]}
    decode_q = {(q.rid, q.attempt) for q in eng.quarantine_log if q.where == "decode"}
    assert hit == decode_q
    prefill_q = [(q.rid, q.attempt) for q in eng.quarantine_log if q.where == "prefill"]
    assert prefill_q == [(rid, att) for kind, rid, att, *_ in log if kind == "prefill"]


def test_instrumentation_never_changes_a_stream(weights, chaos_runs):
    _, tside = weights
    _, _, bare = _run(tside, TEngine, None, None, t_storm)
    _, _, inst = _run(tside, TEngine, tobs.Observability, tobs.MetricsRegistry, t_storm)
    assert bare == inst and sorted(bare) == list(range(7))
    # the requests the chaos run did not fail finish with the fault-free
    # streams, the retried ones included
    (_, _, _), (_, _, chaos) = chaos_runs
    assert {r: bare[r] for r in chaos} == chaos


# ---------------------------------------------------------------------------
# the train loop and the CLIs
# ---------------------------------------------------------------------------


def _reference_train_metrics():
    """{name: kind} the reference's train loop and pack gauges register,
    read from their source (running the reference loop would compile it)."""
    text = ((SRC / "repro/launch/train.py").read_text()
            + (SRC / "repro/core/pack.py").read_text())
    return {name: kind for kind, name in re.findall(
        r'\.(counter|gauge|histogram)\(\s*"((?:train|kernel)_\w+)"', text)}


def test_train_cli_preempts_resumes_and_writes_reference_metrics(tmp_path):
    """``train.main`` with ``--preempt-at``: the run stops at step 3 after a
    forced save, restarts from it and finishes; ``--trace-out`` and
    ``--metrics-out`` carry the reference's train_* and kernel_* names."""
    from repro_torch.launch.train import main

    tr, me = tmp_path / "trace.json", tmp_path / "metrics.prom"
    state, log = main(["--smoke", "--device", "cpu", "--steps", "6", "--delta-t", "2",
                       "--kernel", "block_sparse", "--block", "16", "--batch", "2",
                       "--seq", "16", "--workdir", str(tmp_path / "w"),
                       "--preempt-at", "3", "--max-restarts", "1",
                       "--trace-out", str(tr), "--metrics-out", str(me)])
    assert state["step"] == 6 and [r["step"] for r in log] == [6]
    ckpt = sorted(p.name for p in (tmp_path / "w" / "ckpt").glob("step-*"))
    assert ckpt == ["step-0000000003", "step-0000000006"]
    parsed = tobs.parse_prometheus_text(me.read_text())
    want = _reference_train_metrics()
    assert set(want) == set(parsed["#types"]) and parsed["#types"] == want
    assert parsed["train_steps_total"][frozenset()] >= 3
    assert parsed["train_pack_stale"][frozenset()] == 0
    events = json.loads(tr.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"train_step", "train", "thread_name", "process_name"} <= names


def test_train_cli_default_workdir_is_fresh(tmp_path, monkeypatch, capsys):
    """Without ``--workdir`` each run gets a new directory under the temp
    root: a second run restores nothing of the first and trains every step."""
    import tempfile

    from repro_torch.launch.train import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--method", "static"]
    for _ in range(2):
        state, _ = main(argv)
        assert state["step"] == 2
        assert "restored checkpoint" not in capsys.readouterr().out
    runs = sorted(tmp_path.glob("repro_torch_train-*"))
    assert len(runs) == 2
    for run in runs:
        assert [p.name for p in (run / "ckpt").glob("step-*")] == ["step-0000000002"]


def test_serve_cli_lockstep_and_obs(tmp_path):
    """``serve.main``: ``--lockstep`` returns (batch, gen) finite tokens;
    the engine with ``--trace-out``/``--metrics-out`` writes a Chrome trace
    and metrics that parse to its request counts."""
    from repro_torch.launch.serve import main

    common = ["--smoke", "--device", "cpu", "--kernel", "block_sparse",
              "--block", "16", "--attn-kernel", "flash_tight"]
    toks, stats = main(common + ["--lockstep", "--batch", "3", "--prompt-len", "9",
                                 "--gen", "5"])
    assert tuple(toks.shape) == (3, 5) and stats["tok_per_s"] > 0
    tr, me = tmp_path / "t.json", tmp_path / "m.prom"
    stats = main(common + ["--requests", "3", "--trace-out", str(tr),
                           "--metrics-out", str(me)])
    parsed = tobs.parse_prometheus_text(me.read_text())
    done = parsed["serve_requests_total"][frozenset({("status", "DONE")})]
    assert done == stats["requests"] == 3
    assert parsed["#types"]["kernel_grid_fraction"] == "gauge"
    events = json.loads(tr.read_text())["traceEvents"]
    assert sum(e["name"] == "prefill" for e in events) == 3


def test_lockstep_tokens_match_reference(weights):
    """``serve_session`` on the reference's prompt and the bridged weights:
    the same greedy tokens as the reference's ``serve_session``."""
    from repro.data import batch_for
    from repro.launch.serve import serve_session as j_session
    from repro_torch.launch.serve import serve_session as t_session

    (jcfg, jp), (tcfg, tp) = weights
    batch, prompt_len, gen = 3, 9, 6
    want, _ = j_session(jcfg, jp, batch=batch, prompt_len=prompt_len, gen=gen)
    prompt = np.array(batch_for(jcfg, 0, batch, prompt_len + 1,
                                  learnable=True)["tokens"])[:, :prompt_len]
    got, stats = t_session(tcfg, tp, batch=batch, prompt_len=prompt_len, gen=gen,
                           prompt=torch.from_numpy(prompt).long())
    assert got.tolist() == np.asarray(want).tolist()
    assert len(set(got.flatten().tolist())) > 3  # not degenerate
    assert stats["tok_per_s"] > 0 and stats["decode_s_per_tok"] > 0
