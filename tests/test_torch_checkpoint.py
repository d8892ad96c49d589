"""The port's checkpoints (``repro_torch/checkpoint``) against the JAX
package's, and the train loop's restarts.

A checkpoint is a directory of one ``arrays.npz`` (``path_name`` leaves,
``/`` written as ``|``, masks bit-packed under ``__packedmask__/``) and a
manifest written last; both packages write and read that layout, so each
restores the other's.  Each package has one leaf the other lacks (the
reference's ``rng``, the port's ``seed``): the cross-package restores trim
the template to the shared leaves.  The reference cannot restore a bf16
leaf from disk at all (numpy stores its ``ml_dtypes`` bits as ``|V2``,
which ``jnp.asarray`` cannot cast), so the port -> reference direction
runs on an f32 state; the reference -> port direction carries bf16.

The resume tests hold ``run_with_restarts`` (a forced save at
``preempt_at``, ``SimulatedPreemption``, a restore) to an uninterrupted
``train_loop`` from the same seed, leaf for leaf and bit for bit, with a
drop/grow on each side of the restart.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import checkpoint as j_ckpt  # noqa: E402
from repro.configs import SparseConfig, get_config  # noqa: E402
from repro.core.masks import path_name  # noqa: E402
from repro.core.masks import tree_paths as j_tree_paths  # noqa: E402
from repro.core.pack import is_pack_entry  # noqa: E402
from repro.optim import OptConfig  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save  # noqa: E402
from repro_torch.configs import SparseConfig as TSparse  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import tree_map  # noqa: E402
from repro_torch.core.pack import pack_entries, pack_mismatch, validate_pack  # noqa: E402
from repro_torch.launch.train import run_with_restarts, train_loop  # noqa: E402
from repro_torch.optim.optimizers import OptConfig as TOpt  # noqa: E402
from repro_torch.training.steps import init_train_state  # noqa: E402

BLOCK = 16
SPARSE = dict(sparsity=0.8, method="rigl", kernel="block_sparse",
              block_shape=(BLOCK, BLOCK), kernel_block=(128, BLOCK, BLOCK),
              attn_kernel="flash_tight", delta_t=2)
STEP0 = "step-0000000007"


def _tcfg(arch="h2o-danube-1.8b", **sparse):
    return dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32",
                               sparse=TSparse(**dict(SPARSE, **sparse)))


def _items(tree):
    """[(path_name, leaf)] in flatten order, None leaves kept."""
    out = []
    tree_map(lambda n, v: out.append((n, v)), tree)
    return out


def _assert_same(a, b, what=""):
    """Bit for bit: same structure, kinds, dtypes, devices and bits."""
    ia, ib = _items(a), _items(b)
    assert [n for n, _ in ia] == [n for n, _ in ib], what
    for (n, x), (_, y) in zip(ia, ib):
        if x is None or not torch.is_tensor(x):
            assert type(x) is type(y) and x == y, f"{what} {n}: {x!r} vs {y!r}"
            continue
        assert torch.is_tensor(y) and x.dtype == y.dtype and x.shape == y.shape, (what, n)
        assert x.device == y.device, (what, n)
        if x.is_floating_point():
            x, y = x.view(torch.int16 if x.element_size() == 2 else torch.int32), \
                y.view(torch.int16 if y.element_size() == 2 else torch.int32)
        assert torch.equal(x, y), f"{what} {n} differs"


@pytest.fixture(scope="module")
def port_state():
    """A port train state with every kind of leaf: f32 params, bf16 SGD
    momentum, bool masks and supersets (None leaves for the dense params),
    int32 pack tensors, host ints (step, seed, the packs' nnz/nkb/bnnz)."""
    st, _ = init_train_state(_tcfg(), TOpt(kind="sgd", state_dtype="bfloat16"),
                             seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tree_map(lambda _, m: None if m is None else m.normal_(generator=gen),
             st["opt"]["momentum"])
    st["step"] = 11
    return st


def test_roundtrip_bit_exact(port_state, tmp_path):
    save(port_state, tmp_path, 7)
    got, step = restore(port_state, tmp_path)
    assert step == 7
    _assert_same(got, port_state, "roundtrip")
    names = dict(_items(port_state))
    assert names["opt/momentum/layers/0/mlp/wi/w"].dtype == torch.bfloat16
    assert names["masks/layers/0/attn/wq/w"].dtype == torch.bool
    assert names["masks/embed/table"] is None
    assert isinstance(names["pack/layers/0/mlp/wi/w/nnz"], int)


def test_layout_and_masks_bitpacked(port_state, tmp_path):
    """The reference's layout: ``|``-joined names, masks bit-packed under
    ``__packedmask__/`` with their shapes in the manifest, None leaves
    listed, host ints as 0-d int32, bf16 as its 2-byte bits, and the
    manifest's ``arrays_bytes`` equal to the blob's size."""
    save(port_state, tmp_path, 7)
    d = tmp_path / STEP0
    meta = json.loads((d / "manifest.json").read_text())
    assert meta["step"] == 7 and meta["arrays_bytes"] == (d / "arrays.npz").stat().st_size
    assert "masks/embed/table" in meta["none_leaves"]
    with np.load(d / "arrays.npz") as z:
        files = set(z.files)
        packed = [k for k in files if k.startswith("__packedmask__")]
        masks = {n: m for n, m in _items(port_state["masks"]) if m is not None}
        assert sorted(packed) == sorted(
            "__packedmask__|masks|" + n.replace("/", "|") for n in masks)
        bits = sum(m.numel() for m in masks.values())
        assert sum(z[k].size for k in packed) <= bits // 8 + len(packed)
        for n, m in masks.items():
            assert meta["mask_shapes"]["masks/" + n] == list(m.shape)
        assert z["step"].dtype == np.int32 and z["step"].shape == () and int(z["step"]) == 11
        assert z["pack|layers|0|mlp|wi|w|nnz"].dtype == np.int32
        mom = z["opt|momentum|layers|0|mlp|wi|w"]
        assert mom.dtype == np.dtype("V2")
        want = port_state["opt"]["momentum"]["layers"][0]["mlp"]["wi"]["w"]
        assert mom.tobytes() == want.view(torch.int16).numpy().tobytes()
        # the Top-KAST supersets are not under masks/: stored as bool arrays
        assert z["bwd_masks|layers|0|mlp|wi|w"].dtype == np.bool_


def test_keep_last_k(port_state, tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(port_state, tmp_path, s, keep_last_k=2)
    assert sorted(p.name for p in tmp_path.glob("step-*")) == [
        "step-0000000004", "step-0000000005"]


def _tear(tmp_path, how):
    d = tmp_path / "step-0000000002"
    blob = d / "arrays.npz"
    if how == "torn":  # crash before the manifest
        (d / "manifest.json").unlink()
    elif how == "garbage_manifest":
        (d / "manifest.json").write_text("{not json")
    elif how == "wrong_size":  # truncated copy: the size check fails
        blob.write_bytes(blob.read_bytes()[: blob.stat().st_size // 2])
    elif how == "corrupt_member":  # same size, garbage inside the zip
        data = bytearray(blob.read_bytes())
        data[100:4000] = bytes(3900)
        blob.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["torn", "garbage_manifest", "wrong_size",
                                 "corrupt_member"])
def test_broken_newest_checkpoint_skipped(port_state, tmp_path, how):
    save(port_state, tmp_path, 1)
    save(port_state, tmp_path, 2)
    _tear(tmp_path, how)
    if how != "corrupt_member":  # the size check passes a corrupt member
        assert latest_step(tmp_path) == 1
    got, step = restore(port_state, tmp_path)
    assert step == 1
    _assert_same(got, port_state, how)
    # an explicit step is the caller's decision: errors propagate
    with pytest.raises(Exception):
        restore(port_state, tmp_path, step=2)


def test_stray_tmp_dirs_swept(port_state, tmp_path):
    stray = tmp_path / "tmp-999"
    stray.mkdir(parents=True)
    (stray / "arrays.npz").write_bytes(b"partial")
    save(port_state, tmp_path, 5)
    assert not stray.exists() and latest_step(tmp_path) == 5
    with pytest.raises(FileNotFoundError):
        restore(port_state, tmp_path / "nothing-here")


def test_missing_leaf_fallbacks(port_state, tmp_path):
    """A checkpoint without ``pack`` or ``nonfinite_steps`` restores them
    from the template; any other missing leaf raises KeyError."""
    old = {k: v for k, v in port_state.items() if k not in ("pack", "nonfinite_steps")}
    save(old, tmp_path, 7)
    got, _ = restore(port_state, tmp_path)
    assert got["pack"] is not None
    _assert_same(got["pack"], port_state["pack"], "pack fallback")
    assert torch.equal(got["nonfinite_steps"], port_state["nonfinite_steps"])
    _assert_same(got["params"], port_state["params"], "params")
    bare = {k: v for k, v in port_state.items() if k != "opt"}
    save(bare, tmp_path / "bare", 1)
    with pytest.raises(KeyError, match="opt/momentum"):
        restore(port_state, tmp_path / "bare")


def test_async_snapshot_isolated_from_inplace_updates(port_state, tmp_path):
    """``maybe_save`` returns with an owned host copy: the in-place
    optimizer updates that follow (``dst.copy_``) never reach the file."""
    st = tree_map(lambda _, v: v.clone() if torch.is_tensor(v) else v, port_state)
    want = tree_map(lambda _, v: v.clone() if torch.is_tensor(v) else v, st)
    ck = Checkpointer(tmp_path, every=1)
    ck.maybe_save(st, 7)
    tree_map(lambda _, v: v.add_(1.0) if torch.is_tensor(v) and v.is_floating_point()
             else None, st["params"])
    tree_map(lambda _, v: v.copy_(torch.zeros_like(v)) if torch.is_tensor(v) else None,
             st["opt"])
    ck.wait()
    assert {"snapshot_s", "write_s", "wait_s"} <= set(ck.timings)
    got, step = ck.restore_or_none(port_state)
    assert step == 7
    _assert_same(got, want, "async snapshot")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _flat(tree):
    return {n: np.asarray(v) for n, v in j_tree_paths(tree).items()}


def _ref_state(opt_cfg):
    jcfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                               dtype="float32", sparse=SparseConfig(**SPARSE))
    st, _, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg, opt_cfg)
    return st


def _bridged(st):
    flat_k, _ = jax.tree_util.tree_flatten_with_path(st["pack"], is_leaf=is_pack_entry)
    opt = {k: (int(v) if k == "count" else _flat(v)) for k, v in st["opt"].items()}
    return bridge.train_state_from_flat(
        _flat(st["params"]), _flat(st["masks"]),
        pack={path_name(p): e for p, e in flat_k if e is not None},
        bwd_masks=_flat(st["bwd_masks"]), opt=opt, step=int(st["step"]),
        nonfinite_steps=int(st["nonfinite_steps"]), device="cpu")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """``repro.checkpoint.save`` -> the port's ``restore`` equals the
    bridged state bit for bit, the bf16 SGD momentum included."""
    st = _ref_state(OptConfig(kind="sgd", state_dtype="bfloat16"))
    gen = np.random.default_rng(0)
    st["opt"] = {"momentum": jax.tree_util.tree_map(
        lambda m: (gen.standard_normal(m.shape, np.float32)).astype(m.dtype),
        st["opt"]["momentum"])}
    j_ckpt.save(st, tmp_path, 4)
    want = _bridged(st)
    template = {k: v for k, v in want.items() if k != "seed"}
    got, step = restore(template, tmp_path)
    assert step == 4
    assert got["opt"]["momentum"]["layers"][0]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    _assert_same(got, template, "reference -> port")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's ``save`` -> ``repro.checkpoint.restore`` equals
    ``bridge.flat_of`` of the port's state bit for bit, and the pack
    ``bridge.pack_flat_of``'s (f32 Adam state: see the module
    docstring)."""
    st = _ref_state(OptConfig(kind="adam"))
    tst = _bridged(st)
    gen = torch.Generator().manual_seed(1)
    tree_map(lambda _, v: v.normal_(generator=gen), tst["opt"]["m"])
    tst["step"] = 9
    save(tst, tmp_path, 9)
    template = {k: v for k, v in st.items() if k != "rng"}
    got, step = j_ckpt.restore(template, tmp_path)
    assert step == 9 and int(got["step"]) == 9
    for key in ("params", "masks", "bwd_masks"):
        want = bridge.flat_of(tst[key])
        have = _flat(got[key])
        assert sorted(have) == sorted(want), key
        for n in want:
            assert have[n].dtype == want[n].dtype and np.array_equal(have[n], want[n]), n
    for key in ("m", "v"):
        want = bridge.flat_of(tst["opt"][key])
        have = _flat(got["opt"][key])
        for n in want:
            assert np.array_equal(have[n].view(np.int32), want[n].view(np.int32)), n
    assert int(got["opt"]["count"]) == int(tst["opt"]["count"])
    flat_k, _ = jax.tree_util.tree_flatten_with_path(got["pack"], is_leaf=is_pack_entry)
    have = {path_name(p): e for p, e in flat_k if e is not None}
    want = bridge.pack_flat_of(tst["pack"])
    assert sorted(have) == sorted(want)
    for n, e in want.items():
        for k, v in e.items():
            assert np.array_equal(np.asarray(have[n][k]), np.asarray(v)), (n, k)


# ---------------------------------------------------------------------------
# restarts: run_with_restarts against an uninterrupted train_loop
# ---------------------------------------------------------------------------


def _resume_pair(tmp_path, cfg, preempt_at, steps=6):
    kw = dict(cfg=cfg, steps=steps, batch=2, seq=16, log_every=1, device="cpu")
    straight, log_s = train_loop(workdir=str(tmp_path / "straight"), ckpt_every=None, **kw)
    resumed, log_r = run_with_restarts(workdir=str(tmp_path / "resumed"),
                                       preempt_at=preempt_at, ckpt_every=0, **kw)
    return straight, log_s, resumed, log_r


@pytest.mark.parametrize("arch,kernel,preempt_at", [
    pytest.param("h2o-danube-1.8b", "block_sparse", 3, id="block_sparse"),
    pytest.param("h2o-danube-1.8b", "block_sparse", 4, id="block_sparse_plain_step"),
    pytest.param("h2o-danube-1.8b", "masked", 3, id="masked"),
    pytest.param("qwen2-moe-a2.7b", "block_sparse", 3, id="moe"),
])
def test_resume_bit_exact(tmp_path, arch, kernel, preempt_at):
    """Updates at steps 2 and 4 (t_end = 6): one before the preemption, one
    after the restore.  Every leaf of the state (params, masks, supersets,
    Adam moments, pack, the non-finite counter) and the losses after the
    restart equal the uninterrupted run's.  Preempting at step 4 (after a
    plain step) checks that the restore keeps the saved supersets instead
    of drawing new ones."""
    cfg = _tcfg(arch, kernel=kernel, t_end_fraction=1.0)
    straight, log_s, resumed, log_r = _resume_pair(tmp_path, cfg, preempt_at)
    assert [r["step"] for r in log_r] == list(range(preempt_at + 1, 7))
    assert [r["loss"] for r in log_r] == [r["loss"] for r in log_s][preempt_at:]
    _assert_same(resumed, straight, "resumed vs uninterrupted")
    assert straight["step"] == 6
    ckpts = sorted(p.name for p in (tmp_path / "resumed" / "ckpt").glob("step-*"))
    assert ckpts == [f"step-{preempt_at:010d}", "step-0000000006"]
    assert not (tmp_path / "straight" / "ckpt").exists()
    if kernel == "block_sparse":
        validate_pack(resumed["pack"])
        assert int(pack_mismatch(resumed["masks"], resumed["pack"], (BLOCK, BLOCK),
                                 bwd_masks=resumed["bwd_masks"])) == 0
        assert len(list(pack_entries(resumed["pack"]))) > 0


def test_restart_resumes_from_the_newest_checkpoint(tmp_path):
    """A second train_loop on the same workdir restores the final state
    (the newest of the periodic saves) and trains nothing more."""
    cfg = _tcfg(t_end_fraction=1.0)
    kw = dict(cfg=cfg, batch=2, seq=16, log_every=1, device="cpu",
              workdir=str(tmp_path))
    done, _ = train_loop(steps=4, ckpt_every=2, **kw)
    assert latest_step(tmp_path / "ckpt") == 4
    again, log = train_loop(steps=4, **kw)
    assert log == [] and again["step"] == 4
    _assert_same(again, done, "restored final state")
