"""The port's logical axes, mesh, sharding resolver and data-parallel
training against the JAX package.

The resolver (``repro_torch.launch.sharding``) is held to the reference's
on the reference's own ``FakeMesh`` cases and on every config's smoke
state; the axes trees (``models.model.lm_axes``) to the reference's
``init_lm`` axes.  Data parallelism runs two gloo ranks on the CPU, each a
subprocess that imports no JAX, on danube SMOKE at f32 (sparsity 0.5, SGD
momentum 0.9, 5 steps at 8 x 64 with a drop/grow at step 2, as the
reference's ``DIST_SCRIPT`` with an update): their losses agree with the
single-process port's and with the reference's single-device run within
the reference's own rel 2e-3 (rank means summed and halved round
differently from one mean), and the masks after the drop/grow are the same
on both ranks, bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.sharding as j_sharding  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.data import batch_for  # noqa: E402
from repro.models.model import init_lm as j_init_lm  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import init_train_state, make_algo, make_rigl_step, make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import tree_map  # noqa: E402
from repro_torch.launch import sharding as t_sharding  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.model import lm_axes  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})

# the reference's resolver cases (tests/test_sharding.py), same inputs
RESOLVER_CASES = {
    "heads_sharded_when_divisible": (("embed", "heads"), (2560, 8192), MESH, False),
    "fused_head_dim_shards_when_divisible": (("embed", "heads"), (896, 896), MESH, False),
    "nondivisible_dim_replicated": (("embed", "heads"), (100, 100), MESH, False),
    "experts_get_model_axis_when_divisible": (
        ("experts", "embed", "moe_mlp"), (16, 1024, 4096), MESH, False),
    "grok_fallback_intra_expert_tp": (
        ("experts", "embed", "moe_mlp"), (8, 6144, 32768), MESH, False),
    "fsdp_shards_embed_dim": (("embed", "mlp"), (12288, 28672), MESH, True),
    "fsdp_skips_tiny_vectors": (("embed",), (2560,), MESH, True),
    "kv_seq_fallback_for_nondivisible_kv_heads": (
        ("act_batch", "act_kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128), MESH, False),
    "long_context_batch1_uses_all_axes_for_seq": (
        ("act_batch", "act_kv_seq", "kv_heads", "head_dim"), (1, 524288, 8, 80), MESH, False),
    "multipod_batch_over_pod_and_data": (("act_batch", None, None), (256, 4096, 896), POD,
                                         False),
}


def _spec(s, ndim=None):
    """A reference PartitionSpec (or the port's tuple) as a plain tuple,
    padded with None to ``ndim``."""
    t = tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in s)
    return t if ndim is None else t + (None,) * (ndim - len(t))


@pytest.mark.parametrize("case", sorted(RESOLVER_CASES))
def test_resolve_spec_matches_reference(case):
    axes, shape, mesh, fsdp = RESOLVER_CASES[case]
    want = _spec(j_sharding.resolve_spec(axes, shape, mesh, fsdp=fsdp), len(shape))
    got = t_sharding.resolve_spec(axes, shape, mesh, fsdp=fsdp)
    assert got == want, (case, got, want)


@pytest.fixture(scope="module")
def ref_axes():
    """{arch: the reference's init_lm axes tree} at SMOKE (one init each)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            # traced, not run: the axes are python values beside the shapes
            def init(key):
                params, cache[arch], _ = j_init_lm(key, get_config(arch, smoke=True))
                return params

            jax.eval_shape(init, jax.random.PRNGKey(0))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_matches_reference(arch, ref_axes):
    """``lm_axes`` (an init on the meta device) gives the reference's axes
    tree, leaf for leaf; the meta tensors' shapes are init_lm's."""
    tcfg = t_get_config(arch, smoke=True)
    assert lm_axes(tcfg) == ref_axes(arch)


def _ref_state_like(tst):
    """The port's train state as the reference's ``state_shardings`` reads
    it: shapes of params and masks (None where dense), the optimizer's
    keys, the scalars."""
    sds = lambda _, t: None if t is None else jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
    out = {"step": 0, "rng": 0, "params": tree_map(sds, tst["params"]),
           "masks": tree_map(sds, tst["masks"]),
           "opt": {k: None for k in tst["opt"]}, "nonfinite_steps": 0}
    if "dense_mom" in tst:
        out["dense_mom"] = out["params"]
    return out


def _walk_specs(tree, prefix=""):
    """{path: spec tuple} of a spec tree (the port's tuples or the
    reference's PartitionSpecs)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk_specs(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_walk_specs(v, f"{prefix}{i}/"))
        return out
    return {} if tree is None else {prefix.rstrip("/"): _spec(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_and_cache_axes_match_reference(arch, ref_axes, monkeypatch):
    """``state_shardings`` of every config's smoke state (SNFS under the
    masked kernels and Adam: masks, supersets, carrier pack, moments and
    dense momentum) on a (16, 16) and a (2, 16, 16) mesh, with and without
    FSDP, against the reference's specs; the superset, the pack and the
    port's seed as the port's docstring says; ``cache_axes`` equal."""
    monkeypatch.setattr(j_sharding, "NamedSharding", lambda mesh, spec: spec)
    tcfg = t_get_config(arch, smoke=True)
    tcfg = dataclasses.replace(tcfg, sparse=TSparse(sparsity=0.5, method="snfs",
                                                    kernel="masked"))
    tst, _ = tsteps.init_train_state(tcfg, TOpt(kind="adam"), seed=0, device="cpu")
    axes = lm_axes(tcfg)
    like = _ref_state_like(tst)
    for mesh in (MESH, POD):
        for fsdp in (False, True):
            got = t_sharding.state_shardings(tst, axes, mesh, fsdp=fsdp)
            want = j_sharding.state_shardings(like, ref_axes(arch), mesh, fsdp=fsdp)
            for key in ("step", "params", "masks", "opt", "nonfinite_steps", "dense_mom"):
                g, w = _walk_specs(got[key]), _walk_specs(want[key])
                assert g == w, (arch, mesh.shape, fsdp, key)
            assert got["seed"] == t_sharding.REPLICATED
            assert _walk_specs(got["bwd_masks"]) == _walk_specs(got["masks"])
            assert set(_walk_specs(got["pack"]).values()) == {()}
    assert t_sharding.cache_axes(tcfg) == j_sharding.cache_axes(get_config(arch, smoke=True))


def test_placements_follow_the_spec():
    """A spec -> DTensor placements, one per mesh axis, in mesh order; a
    dim over several axes in another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    class M:
        axis_names = ("pod", "data", "model")

    assert t_sharding.placements((("pod", "data"), None, "model"), M) == [
        Shard(0), Shard(0), Shard(2)]
    assert t_sharding.placements((None, "model"), M) == [Replicate(), Replicate(), Shard(1)]
    assert t_sharding.placements((), M) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        t_sharding.placements((("model", "data"),), M)


# ---------------------------------------------------------------------------
# data parallelism: two gloo ranks on the CPU
# ---------------------------------------------------------------------------

DP_STEPS, DP_BATCH, DP_SEQ, DP_UPDATE = 5, 8, 64, 2

RANK_SCRIPT = textwrap.dedent(
    """
    import dataclasses, hashlib, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.masks import tree_paths
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import shard_batch
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps as ts

    rank, world, store, inputs = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, world_size=world,
                            rank=rank)
    data = torch.load(inputs, weights_only=False)
    cfg, opt = data["cfg"], data["opt"]
    lr = LRSchedule(kind="constant", base_lr=1e-2, warmup_steps=0)
    st = data["state"]
    mesh = make_local_mesh(world, 1, device_type="cpu")
    step = ts.make_train_step(cfg, opt, lr, mesh=mesh)
    rigl = ts.make_rigl_step(cfg, ts.make_algo(cfg, data["steps"]), lr, mesh=mesh)
    losses = []
    for t, b in enumerate(data["batches"]):
        b = shard_batch(b, mesh)
        if t == data["update"]:
            st, m = rigl(st, b)
            st = ts.refresh_pack(st, cfg)
        else:
            st, m = step(st, b)
        losses.append(float(m["loss"]))
    out = {"rank": rank, "rows": int(b["tokens"].shape[0]), "losses": losses,
           "masks": {n: hashlib.sha256(m.numpy().tobytes()).hexdigest()
                     for n, m in tree_paths(st["masks"]).items()}}
    refusals = {}
    for name, kw, shape in (("n_model", {}, (1, 2)),
                            ("fsdp", {"fsdp": True}, (2, 1)),
                            ("fused", {"fused": True}, (2, 1))):
        c = dataclasses.replace(cfg, fsdp=kw.get("fsdp", False))
        if kw.get("fused"):
            c = dataclasses.replace(c, sparse=dataclasses.replace(
                c.sparse, kernel="masked", fused_epilogue=True))
        try:
            ts.make_train_step(c, opt, lr, mesh=make_local_mesh(*shape, device_type="cpu"))
            refusals[name] = None
        except (NotImplementedError, ValueError) as e:
            refusals[name] = type(e).__name__ + ": " + str(e)
    out["refusals"] = refusals
    from repro_torch.launch.train import train_loop
    work = data["workdir"] + "/rank" + str(rank)
    _, log = train_loop(cfg, steps=3, batch=8, seq=32, workdir=work, device="cpu",
                        ckpt_every=None, log_every=1, mesh=mesh)
    out["train_loop"] = {"losses": [r["loss"] for r in log], "workdir": work}
    print(json.dumps(out))
    dist.destroy_process_group()
    """
)


def _dp_cfgs():
    base = dict(dtype="float32")
    sp = dict(sparsity=0.5, delta_t=DP_UPDATE)
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               sparse=SparseConfig(**sp), **base)
    tcfg = dataclasses.replace(t_get_config("h2o-danube-1.8b", smoke=True),
                               sparse=TSparse(**sp), **base)
    return jcfg, tcfg


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The reference's single-device run, the port's single-process run
    and the port's two ranks, from one bridged initial state and the
    reference's batches -> {"ref": losses, "single": losses, "ranks":
    [rank 0's report, rank 1's]}."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg, tcfg = _dp_cfgs()
    jopt, topt = (C(kind="sgd", momentum=0.9, weight_decay=0.0) for C in (OptConfig, TOpt))
    j_lr, t_lr = (L(kind="constant", base_lr=1e-2, warmup_steps=0) for L in (LRSchedule, TLR))
    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg, jopt)

    def port_state():
        return bridge.train_state_from_flat(
            _flat(st["params"]), _flat(st["masks"]),
            opt={"momentum": _flat(st["opt"]["momentum"])}, device="cpu")

    jbs = [batch_for(jcfg, t, DP_BATCH, DP_SEQ, learnable=True) for t in range(DP_STEPS)]
    tbs = [{k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()} for jb in jbs]
    torch.save({"cfg": tcfg, "opt": topt, "state": port_state(), "batches": tbs,
                "steps": DP_STEPS, "update": DP_UPDATE, "workdir": str(tmp)},
               tmp / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), "2", str(tmp / "store"),
         str(tmp / "inputs.pt")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(2)]

    j_step = jax.jit(make_train_step(jcfg, jopt, j_lr))
    j_rigl = jax.jit(make_rigl_step(jcfg, make_algo(jcfg, DP_STEPS), j_lr))
    t_state = port_state()
    t_step = tsteps.make_train_step(tcfg, topt, t_lr)
    t_rigl = tsteps.make_rigl_step(tcfg, tsteps.make_algo(tcfg, DP_STEPS), t_lr)
    ref, single = [], []
    for t in range(DP_STEPS):
        if t == DP_UPDATE:
            st, jm = j_rigl(st, jbs[t])
            t_state, tm = t_rigl(t_state, tbs[t])
            t_state = tsteps.refresh_pack(t_state, tcfg)
        else:
            st, jm = j_step(st, jbs[t])
            t_state, tm = t_step(t_state, tbs[t])
        ref.append(float(jm["loss"]))
        single.append(float(tm["loss"]))

    _, loop_log = train_loop(tcfg, steps=3, batch=8, seq=32, workdir=str(tmp / "single"),
                             device="cpu", ckpt_every=None, log_every=1)
    reports = []
    for p in ranks:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return {"ref": ref, "single": single, "ranks": reports,
            "train_loop": [r["loss"] for r in loop_log]}


def test_two_ranks_match_single_process_and_reference(dp_run):
    """Each rank trains on its half of the rows; the data-parallel losses
    (the same on both ranks, bit for bit) equal the single-process port's
    and the reference's within rel 2e-3 (tests/test_sharding.py's bound)."""
    r0, r1 = dp_run["ranks"]
    assert r0["rows"] == r1["rows"] == DP_BATCH // 2
    assert r0["losses"] == r1["losses"]
    for want in (dp_run["single"], dp_run["ref"]):
        for a, b in zip(r0["losses"], want):
            assert a == pytest.approx(b, rel=2e-3), (r0["losses"], want)


def test_masks_identical_across_ranks_after_drop_grow(dp_run):
    """The drop/grow reads the all-reduced gradient: both ranks hold the
    same masks, bit for bit."""
    r0, r1 = dp_run["ranks"]
    assert r0["masks"] and r0["masks"] == r1["masks"]


def test_train_loop_on_two_ranks(dp_run):
    """``train_loop(mesh=)``, the entry point: each rank builds the global
    batch from the seed and keeps its rows; the losses equal the
    single-process loop's within rel 2e-3, the same on both ranks; rank 0
    alone writes result.json."""
    r0, r1 = (r["train_loop"] for r in dp_run["ranks"])
    assert r0["losses"] == r1["losses"]
    for a, b in zip(r0["losses"], dp_run["train_loop"]):
        assert a == pytest.approx(b, rel=2e-3), (r0["losses"], dp_run["train_loop"])
    assert os.path.exists(os.path.join(r0["workdir"], "result.json"))
    assert not os.path.exists(os.path.join(r1["workdir"], "result.json"))


@pytest.mark.parametrize("what,match", [
    ("n_model", "NotImplementedError: .*model=2.*queue A item 9b"),
    ("fsdp", "NotImplementedError: .*fsdp=True.*queue A item 9b"),
    ("fused", "ValueError: sparse.fused_epilogue on 2 data ranks"),
])
def test_mesh_refusals(dp_run, what, match):
    """On two live ranks: a model axis wider than 1, FSDP, and the fused
    epilogue on two data ranks raise, naming queue A item 9b or the
    reason."""
    import re

    for report in dp_run["ranks"]:
        msg = report["refusals"][what]
        assert msg is not None and re.match(match, msg), msg
