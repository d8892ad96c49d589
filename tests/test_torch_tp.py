"""Tensor and expert parallelism over ``model`` against one process and the
JAX reference.

Ranks are gloo subprocesses on the CPU that import no JAX (one thread
each); one launch a world size runs every case of that size, and the
single-process runs (and the reference's) happen here meanwhile.  All runs
are f32 SMOKE, SGD momentum 0.9, constant lr 1e-2, ``batch_for(...,
learnable=True)``:

  (a) the reference's own distributed case (``tests/test_sharding.py``):
      danube, sparsity 0.5, mesh (data=2, model=4), 5 train steps, a
      drop/grow, 2 more; its kv heads (2 of 16) do not split over 4 ranks,
      so every rank holds ``wk``/``wv`` whole.  Losses within rel 1e-4 of
      the single-process port and 2e-3 of the single-device reference (run
      here: the reference's own sharded run fails, ROADMAP queue C); the
      whole masks equal on all 8 ranks and >= 99.9% equal to the one
      process's; every replicated leaf's gradient the same on every rank,
      and every leaf's step-0 gradient (the sharded ones gathered whole)
      the one process's.
  (b) danube block_sparse with 32 x 32 blocks on (data=1, model=2):
      ``wk``/``wv`` (64 x 32) would split a block, so they run whole;
      through the plain K1-K3 and the flash path.  The same bounds.
  (c) qwen2-moe on model=2 (6 experts: expert parallelism, block_sparse)
      and model=4 (tensor parallelism inside each expert, masked): losses
      within rel 1e-4, the router's gradient the same on every rank and
      the one process's.
  (d) gemma3 (tied vocab-parallel table, here with a final softcap of 30
      so it runs before the vocab-parallel max) on model=2: rel 1e-4.
  (e) a checkpoint saved on (data=2, model=1) and restored onto (data=1,
      model=2), and the other way round: each leaf on disk the one
      process's (masks exactly, floats within 1e-5 of the leaf's largest
      value; a sharded save writes no pack), 2 more steps (a drop/grow
      among them) within rel 1e-5 of an uninterrupted run.
  (f) ``dp_group`` of (pod=2, data=1, model=2): the pod peers of each
      model coordinate, and a train step on that mesh within rel 1e-4.

Also: command-r (parallel blocks), hubert (frames), internvl (patches)
and grok (4 experts, softcaps) on (data=1, model=2) within rel 1e-4 of one
process; and fault C2: qwen2-moe on (data=2, model=1) routes its rows as
the whole batch does, within rel 1e-5 of one process; and ``gather_dim``
by an all-gather and by the zero-filled sum, which agree.
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

from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.data import batch_for as j_batch_for  # noqa: E402
from repro.optim import LRSchedule, OptConfig  # noqa: E402
from repro.training import init_train_state, make_algo, make_rigl_step, make_train_step  # noqa: E402
from repro.training import refresh_pack as j_refresh_pack  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import tree_paths  # noqa: E402
from repro_torch.data.synthetic import batch_for  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim.lr import LRSchedule as TLR  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training import steps as ts  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SEQ = 64
# the other families on model=2: parallel blocks (attention and MLP summed
# over the model ranks once), frames (no embedding, the head vocab-parallel),
# patches in front of the text, grok's 4 experts with both softcaps
FAMILIES = (("command-r-plus-104b", "block_sparse"), ("hubert-xlarge", "block_sparse"),
            ("internvl2-1b", "masked"), ("grok-1-314b", "block_sparse"))

RANK_SCRIPT = textwrap.dedent(
    """
    import hashlib, json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core.masks import tree_map, tree_paths
    from repro_torch.launch.mesh import dp_group, make_mesh
    from repro_torch.launch.sharding import gather_leaf, param_specs, sharded_dims, train_specs
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training import steps as ts

    rank, world, store, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store, world_size=world,
                            rank=rank)
    jobs = torch.load(inputs, weights_only=False)
    opt = OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0)
    lr = LRSchedule(kind="constant", base_lr=1e-2, warmup_steps=0)
    digest = lambda t: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
    report = {"rank": rank}

    def train(job):
        cfg, mesh = job["cfg"], make_mesh(job["mesh"], device_type="cpu")
        st = job.get("state") or ts.init_train_state(cfg, opt, seed=0, device="cpu")[0]
        st = ts.shard_train_state(st, cfg, mesh)
        step = ts.make_train_step(cfg, opt, lr, mesh=mesh)
        rigl = ts.make_rigl_step(cfg, ts.make_algo(cfg, 100), lr, mesh=mesh)
        specs = {}
        tree_map(lambda n, s: specs.__setitem__(n, s), param_specs(cfg, mesh),
                 is_leaf=lambda x: isinstance(x, tuple))
        _, g = step.grads(st, job["batches"][0])
        local = tree_paths(g)
        rep = sorted(n for n, s in specs.items() if not sharded_dims(s))
        # every leaf's step-0 gradient, whole (gathered one leaf at a time)
        grads = {n: gather_leaf(t, specs[n], mesh) for n, t in local.items()}
        res = {"grad_digests": {n: digest(local[n]) for n in rep},
               "whole_grad_digests": {n: digest(t) for n, t in grads.items()},
               "losses": []}
        if rank == 0:
            torch.save({"grads": grads, "replicated": rep},
                       out + "/" + job["name"] + "_grads.pt")
        for t, b in enumerate(job["batches"]):
            if t == job.get("update"):
                st, m = rigl(st, b)
                st = ts.refresh_pack(st, cfg, mesh)
            else:
                st, m = step(st, b)
            res["losses"].append(float(m["loss"]))
        whole = {}
        tree_map(lambda n, m, s: None if m is None else whole.__setitem__(
            n, gather_leaf(m, s, mesh)), st["masks"], train_specs(st, cfg, mesh)["masks"])
        res["mask_digest"] = digest(torch.cat([whole[n].reshape(-1) for n in sorted(whole)]))
        if rank == 0:
            torch.save(whole, out + "/" + job["name"] + "_masks.pt")
        return res

    def ckpt(job):
        cfg, work = job["cfg"], out + "/" + job["name"]
        kw = dict(batch=job["batch"], seq=job["seq"], workdir=work, device="cpu",
                  ckpt_every=0, log_every=1, opt_cfg=opt, lr_sched=lr)
        train_loop(cfg, steps=2, mesh=make_mesh(job["save"], device_type="cpu"), **kw)
        _, log = train_loop(cfg, steps=4, mesh=make_mesh(job["restore"], device_type="cpu"),
                            **kw)
        return {"losses": [r["loss"] for r in log]}

    def group(job):
        mesh = make_mesh(job["mesh"], device_type="cpu")
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=dp_group(mesh))
        res = train(job)
        res["peer_sum"] = float(t)
        res["coord"] = list(mesh.get_coordinate())
        return res

    def gather(job):
        # gather_dim's all-gather against the zero-filled sum of the
        # shards, on each dtype and dim
        from repro_torch.models import tp
        grp, res = dist.group.WORLD, {}
        for dt in (torch.float32, torch.bfloat16, torch.bool):
            for shape, dim in (((4, 6), 0), ((4, 6), 1), ((2, 3, 5), 1)):
                full = (torch.arange(world * torch.Size(shape).numel()) % 7).to(dt)
                full = full.reshape(*shape[:dim], world * shape[dim], *shape[dim + 1:])
                local = full.narrow(dim, rank * shape[dim], shape[dim]).contiguous()
                direct = tp.gather_dim(local, dim, world, grp)
                summed = torch.zeros_like(full)
                summed.narrow(dim, rank * shape[dim], shape[dim]).copy_(local)
                summed = tp.all_reduce_sum(summed, grp)
                res[f"{dt} {shape} {dim}"] = [
                    direct.dtype == dt, summed.dtype == dt, torch.equal(direct, full),
                    torch.equal(summed, full)]
        return res

    for job in jobs:
        report[job["name"]] = {"train": train, "ckpt": ckpt, "group": group,
                              "gather": gather}[job["kind"]](job)
    print(json.dumps(report))
    dist.destroy_process_group()
    """
)


def _cfg(arch, kernel="dense", block=16, **kw):
    sp = dict(sparsity=0.5, delta_t=2, kernel=kernel)
    if kernel == "block_sparse":
        sp.update(block_shape=(block, block), kernel_block=(128, block, block))
    if kernel != "dense":
        sp.update(attn_kernel="flash_tight")
    return dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32",
                               sparse=TSparse(**sp), **kw)


def _batches(cfg, n, rows=8):
    return [batch_for(cfg, t, rows, SEQ, learnable=True) for t in range(n)]


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _ref_cfg(kernel="dense", block=32):
    sp = dict(sparsity=0.5, delta_t=2, kernel=kernel)
    if kernel == "block_sparse":
        sp.update(block_shape=(block, block), kernel_block=(128, block, block),
                  attn_kernel="flash_tight")
    return dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), dtype="float32",
                               sparse=SparseConfig(**sp))


def _ref_start(jcfg, n):
    """The reference's initial state (SGD), its batches, and both bridged
    to the port -> (state, port state, reference batches, port batches)."""
    from test_torch_train import _bridge

    st, _, _ = init_train_state(jax.random.PRNGKey(0), jcfg,
                                OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0))
    if "pack" in st:
        port = _bridge(st)
    else:
        port = bridge.train_state_from_flat(_flat(st["params"]), _flat(st["masks"]),
                                            opt={"momentum": _flat(st["opt"]["momentum"])},
                                            device="cpu")
    jbs = [j_batch_for(jcfg, t, 8, SEQ, learnable=True) for t in range(n)]
    tbs = [{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()} for b in jbs]
    return st, port, jbs, tbs


def _ref_losses(jcfg, st, jbs, update):
    """The reference's single-device run: a train step a batch, the
    drop/grow (and its re-pack) at ``update``."""
    jopt = OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0)
    jlr = LRSchedule(kind="constant", base_lr=1e-2, warmup_steps=0)
    step = jax.jit(make_train_step(jcfg, jopt, jlr))
    rigl = jax.jit(make_rigl_step(jcfg, make_algo(jcfg, 100), jlr))
    losses = []
    for t, b in enumerate(jbs):
        if t == update:
            st, m = rigl(st, b)
            if "pack" in st:
                st = j_refresh_pack(st, jcfg)
        else:
            st, m = step(st, b)
        losses.append(float(m["loss"]))
    return losses


def _single(job):
    """The single-process port on a train job -> (losses, step-0 grads,
    final masks)."""
    cfg = job["cfg"]
    opt = TOpt(kind="sgd", momentum=0.9, weight_decay=0.0)
    lr = TLR(kind="constant", base_lr=1e-2, warmup_steps=0)
    st = job.get("state") or ts.init_train_state(cfg, opt, seed=0, device="cpu")[0]
    st = {k: v for k, v in st.items()}
    step = ts.make_train_step(cfg, opt, lr)
    rigl = ts.make_rigl_step(cfg, ts.make_algo(cfg, 100), lr)
    _, g = step.grads(st, job["batches"][0])
    losses = []
    for t, b in enumerate(job["batches"]):
        if t == job.get("update"):
            st, m = rigl(st, b)
            st = ts.refresh_pack(st, cfg)
        else:
            st, m = step(st, b)
        losses.append(float(m["loss"]))
    return losses, tree_paths(g), tree_paths(st["masks"])


def _launch(world, jobs, tmp):
    torch.save(jobs, tmp / "jobs.pt")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(tmp / "store"),
         str(tmp / "jobs.pt"), str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]


def _collect(procs):
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the rank launches of world 8, 2 and 4 start together;
    the reference and the single-process runs happen meanwhile."""
    root = tmp_path_factory.mktemp("tp")
    ref_a, ref_b = _ref_cfg(), _ref_cfg("block_sparse")
    st_a, state_a, jbs_a, batches_a = _ref_start(ref_a, 8)
    st_b, state_b, jbs_b, batches_b = _ref_start(ref_b, 4)
    danube = _cfg("h2o-danube-1.8b")
    jobs = {
        8: [dict(name="a", kind="train", cfg=danube, mesh={"data": 2, "model": 4},
                 state=state_a, batches=batches_a, update=5)],
        2: [dict(name="b", kind="train", cfg=_cfg("h2o-danube-1.8b", "block_sparse", 32),
                 mesh={"data": 1, "model": 2}, state=state_b, batches=batches_b,
                 update=2),
            dict(name="c_ep", kind="train", cfg=_cfg("qwen2-moe-a2.7b", "block_sparse"),
                 mesh={"data": 1, "model": 2}, update=2),
            dict(name="d", kind="train", cfg=_cfg("gemma3-4b", "masked", final_softcap=30.0),
                 mesh={"data": 1, "model": 2}, update=2),
            dict(name="moe_dp", kind="train", cfg=_cfg("qwen2-moe-a2.7b"),
                 mesh={"data": 2, "model": 1}, update=2),
            *(dict(name=arch, kind="train", cfg=_cfg(arch, kernel),
                   mesh={"data": 1, "model": 2}, update=2) for arch, kernel in FAMILIES),
            dict(name="gather", kind="gather"),
            dict(name="e_dp_to_tp", kind="ckpt", cfg=danube, save={"data": 2, "model": 1},
                 restore={"data": 1, "model": 2}, batch=8, seq=32),
            dict(name="e_tp_to_dp", kind="ckpt", cfg=danube, save={"data": 1, "model": 2},
                 restore={"data": 2, "model": 1}, batch=8, seq=32)],
        4: [dict(name="c_tp", kind="train", cfg=_cfg("qwen2-moe-a2.7b", "masked"),
                 mesh={"data": 1, "model": 4}, update=2),
            dict(name="f", kind="group", cfg=danube, mesh={"pod": 2, "data": 1, "model": 2})],
    }
    for job in jobs[2][1:] + jobs[4]:
        if job["kind"] in ("train", "group"):
            job["batches"] = _batches(job["cfg"], 4)
    procs = {}
    for world, js in jobs.items():
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d, _launch(world, js, d))
    ref = {"a": _ref_losses(ref_a, st_a, jbs_a, 5), "b": _ref_losses(ref_b, st_b, jbs_b, 2)}
    single = {j["name"]: _single(j) for js in jobs.values() for j in js
              if j["kind"] in ("train", "group")}
    ckpt_single = {}
    for job in [j for j in jobs[2] if j["kind"] == "ckpt"][:1]:
        # one uninterrupted run, and the one process's step-2 files
        kw = dict(batch=8, seq=32, device="cpu", ckpt_every=0, log_every=1,
                  opt_cfg=TOpt(kind="sgd", momentum=0.9, weight_decay=0.0),
                  lr_sched=TLR(kind="constant", base_lr=1e-2, warmup_steps=0))
        _, log = train_loop(job["cfg"], steps=4, workdir=str(root / "single4"), **kw)
        train_loop(job["cfg"], steps=2, workdir=str(root / "single2"), **kw)
        ckpt_single = {"losses": [r["loss"] for r in log],
                       "files": root / "single2" / "ckpt" / "step-0000000002"}
    reports = {w: _collect(p) for w, (d, p) in procs.items()}
    return {"ref": ref, "single": single, "reports": reports,
            "dirs": {w: d for w, (d, _) in procs.items()}, "ckpt_single": ckpt_single}


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _check_train(runs, world, name, *, ref=None, rel=1e-4):
    reports = [r[name] for r in runs["reports"][world]]
    losses, grads, masks = runs["single"][name]
    for r in reports:
        assert r["losses"] == reports[0]["losses"]
        assert r["grad_digests"] == reports[0]["grad_digests"], name
        assert r["whole_grad_digests"] == reports[0]["whole_grad_digests"], name
        assert r["mask_digest"] == reports[0]["mask_digest"], name
    assert _rel(reports[0]["losses"], losses) <= rel, (reports[0]["losses"], losses)
    if ref is not None:
        assert _rel(reports[0]["losses"], ref) <= 2e-3, (reports[0]["losses"], ref)
    d = runs["dirs"][world]
    saved = torch.load(d / f"{name}_grads.pt")
    got = saved["grads"]
    # every leaf, the sharded ones gathered whole: column-, row- and
    # vocab-parallel weights, expert banks and replicated leaves alike
    assert set(got) == set(grads), name
    for n, g in got.items():
        assert g.shape == grads[n].shape, n
        assert torch.allclose(g, grads[n], rtol=1e-4, atol=1e-5 * float(grads[n].abs().max())), n
    whole = torch.load(d / f"{name}_masks.pt")
    same = sum(int((whole[n] == m).sum()) for n, m in masks.items())
    assert same >= 0.999 * sum(m.numel() for m in masks.values())
    return reports[0], set(saved["replicated"])


def test_a_reference_case_on_data2_model4(runs):
    """The reference's distributed case on (data=2, model=4)."""
    rep, replicated = _check_train(runs, 8, "a", ref=runs["ref"]["a"])
    assert len(rep["losses"]) == 8
    # replicated leaves: the norm scales, and wk/wv (their 2 kv heads do
    # not split over 4 ranks)
    assert {"ln_f/scale", "layers/0/ln1/scale", "layers/0/attn/wk/w",
            "layers/1/attn/wv/w"} <= replicated
    assert "layers/0/attn/wq/w" not in replicated


def test_b_block_sparse_leaves_held_whole(runs):
    """danube block_sparse at 32 x 32 on model=2: wk/wv run whole."""
    from repro_torch.launch.sharding import whole_leaves

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}

    whole = whole_leaves(_cfg("h2o-danube-1.8b", "block_sparse", 32), Mesh)
    assert whole == {f"layers/{i}/attn/{w}/w": "blocks" for i in range(2)
                     for w in ("wk", "wv")}
    _, replicated = _check_train(runs, 2, "b", ref=runs["ref"]["b"])
    assert "layers/0/attn/wk/w" in replicated


@pytest.mark.parametrize("name,world", [("c_ep", 2), ("c_tp", 4)])
def test_c_moe_expert_and_tensor_parallel(runs, name, world):
    """qwen2-moe: 3 experts a rank on model=2, a quarter of every
    expert's ff on model=4; the router's gradient is every rank's and
    the one process's."""
    _, replicated = _check_train(runs, world, name)
    assert "layers/0/moe/router/w" in replicated


def test_d_gemma3_tied_vocab_parallel_softcap(runs):
    _check_train(runs, 2, "d")


@pytest.mark.parametrize("arch", [a for a, _ in FAMILIES])
def test_other_families_on_model2(runs, arch):
    """command-r, hubert, internvl and grok on (data=1, model=2): losses
    within rel 1e-4 of one process, every leaf's gradient the one
    process's, the whole masks the same on both ranks."""
    _check_train(runs, 2, arch)


def test_moe_routes_the_whole_batch_under_data_parallelism(runs):
    """Fault C2: on rows cut over two data ranks qwen2-moe routes as the
    whole batch does (the capacity of every rank's tokens, ranks after the
    lower data rank's assignments, the aux loss's whole-batch means), as
    the reference under GSPMD: the losses match one process within rel
    1e-5 (each rank routing its own rows at its own capacity missed by
    4.3e-4)."""
    _check_train(runs, 2, "moe_dp", rel=1e-5)


@pytest.mark.parametrize("name", ["e_dp_to_tp", "e_tp_to_dp"])
def test_e_checkpoint_restores_onto_another_mesh(runs, name):
    """Saved on one mesh at step 2, restored onto the other, 2 more steps:
    the files are the one process's, the losses the uninterrupted run's."""
    cs = runs["ckpt_single"]
    for r in runs["reports"][2]:
        got = r[name]["losses"]
        assert len(got) == 2
        assert _rel(got, cs["losses"][2:]) <= 1e-5, (got, cs["losses"])
    files = runs["dirs"][2] / name / "ckpt" / "step-0000000002"
    with np.load(cs["files"] / "arrays.npz") as want, np.load(files / "arrays.npz") as got:
        sharded_save = name == "e_tp_to_dp"
        expect = {k for k in want.files if not (sharded_save and k.startswith("pack|"))}
        assert set(got.files) == expect
        for k in expect:
            a, b = got[k], want[k]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype.kind in "biu":
                assert np.array_equal(a, b), k
            else:
                assert np.allclose(a, b, rtol=0, atol=1e-5 * max(float(np.abs(b).max()), 1e-30)), k


def test_f_dp_group_over_pod_beside_model(runs):
    """(pod=2, data=1, model=2): each rank's data-parallel peers are the
    other pod's rank at its model coordinate; a train step there matches
    one process."""
    reports = runs["reports"][4]
    for r in reports:
        model = r["f"]["coord"][2]
        peers = [q["rank"] for q in reports if q["f"]["coord"][2] == model]
        assert len(peers) == 2 and r["f"]["peer_sum"] == float(sum(peers))
    _check_train(runs, 4, "f")


def test_gather_dim_all_gather_and_sum_agree(runs):
    """``gather_dim`` on two CPU ranks gives the whole tensor in its own
    dtype (f32, bf16, bool) along dim 0 and an inner dim, and so does the
    zero-filled sum of the shards through ``all_reduce_sum``."""
    for r in runs["reports"][2]:
        for case, checks in r["gather"].items():
            assert all(checks), (r["rank"], case, checks)


def test_mask_digests_and_replicated_grads_agree(runs):
    """Across every rank of every launch: the whole masks, every
    replicated leaf's gradient and every leaf's gathered gradient are the
    same."""
    for world, reports in runs["reports"].items():
        for name in reports[0]:
            if name == "rank" or "mask_digest" not in reports[0][name]:
                continue
            assert len({r[name]["mask_digest"] for r in reports}) == 1, (world, name)
            for key in ("grad_digests", "whole_grad_digests"):
                assert len({json.dumps(r[name][key], sort_keys=True)
                            for r in reports}) == 1, (world, name, key)
