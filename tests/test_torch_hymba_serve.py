"""Port hymba (hymba-1.5b) serving vs the JAX package on the smoke config,
block 16: prefill and decode with prompts of 3 and 8 tokens, an inactive
slot frozen bit for bit and the conv state pinned, in f32 and (the conv
state's dtype) in bf16; the engine's greedy streams, contiguous and paged
(a local ring pool and a global pool beside the slot-batched SSM states);
the short-prompt error; the prefix cache refused; the CLIs.

The weights, masks, packs and tolerances are ``test_torch_hymba.py``'s
(the reference's init weights carried by ``bridge``; 1e-4 relative for
f32 results, 5e-3 for the bf16 config's logits).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_hymba import ARCH, BLOCK, TOL, _close, _jx, _ref, _state  # noqa: E402

from repro.launch.serve import staggered_requests as j_requests  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import lm_decode as j_lm_decode  # noqa: E402
from repro.models import lm_prefill_into as j_lm_prefill_into  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.masks import tree_paths  # noqa: E402
from repro_torch.launch.serve import configure_kernel  # noqa: E402
from repro_torch.launch.serve import staggered_requests as t_requests  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.queue import Status  # noqa: E402


def _serve_case(mode, dtype):
    """Two slots admitted (prompts of 3 and 8 tokens) into shared caches,
    then 4 decode steps, slot 0 inactive for the last two: the reference's
    prefill and decode logits, caches, and greedy tokens fed back."""
    jcfg, cfg, params, masks, pack = _state(mode, dtype)
    max_len = 32
    prompts = [np.random.default_rng(20 + s).integers(0, 128, (1, n)).astype(np.int32)
               for s, n in enumerate((3, 8))]
    actives = [np.array([step < 2, True]) for step in range(4)]

    def reference():
        jp, jm = _jx(params), _jx(masks)
        jc = j_init_caches(jcfg, 2, max_len)
        pre = []
        for slot, prompt in enumerate(prompts):
            jl, jc = jax.jit(lambda c, t, s_: j_lm_prefill_into(
                jp, jcfg, c, {"tokens": t}, s_, max_len, masks=jm))(
                jc, jnp.asarray(prompt), slot)
            pre.append((np.asarray(jl), jax.tree_util.tree_map(np.asarray, jc)))
        j_dec = jax.jit(lambda c, t, pos, act: j_lm_decode(
            jp, jcfg, c, t, pos, masks=jm, active=act))
        cur = np.array([int(np.argmax(jl[0, -1])) for jl, _ in pre])
        pos = np.array([3, 8], np.int32)
        steps = []
        for active in actives:
            jl, jc = j_dec(jc, jnp.asarray(cur)[:, None], jnp.asarray(pos),
                           jnp.asarray(active))
            steps.append((cur, pos.copy(), np.asarray(jl),
                          jax.tree_util.tree_map(np.asarray, jc)))
            cur = np.where(active, np.argmax(np.asarray(jl)[:, -1], -1), cur)
            pos = pos + active
        return pre, steps

    return (cfg, params, masks, pack, prompts, actives, max_len,
            _ref(("serve", mode == "dense", dtype), reference))


@pytest.mark.parametrize("mode,dtype,tol", [("masked", "float32", TOL),
                                            ("block_sparse", "float32", TOL),
                                            ("block_sparse", "bfloat16", 5e-3)])
def test_prefill_decode_match_reference_and_freeze_inactive(monkeypatch, mode, dtype,
                                                            tol):
    """Prefill logits and the SSM states against the reference's
    ``lm_prefill_into``; the conv state is pinned bit for bit to the
    reference's recompute (``in_proj`` run again on the layer's input, its
    last 3 rows rounded to the compute dtype: bf16 under the bf16 config),
    done here on the port's side, and within ``tol`` to the reference's
    rows; 4 decode steps' logits and the active slot's SSM states against
    ``lm_decode``; the inactive slot's KV and SSM state bit for bit
    unchanged."""
    cfg, params, masks, pack, prompts, actives, max_len, (pre, steps) = _serve_case(
        mode, dtype)
    w = tm.serving_weights(params, cfg)
    tc = tm.init_caches(cfg, 2, max_len, "cpu")
    seen, real_ssm = [], S.ssm

    def record(p, x, *a, masks=None, pack=None, **kw):
        seen.append((p, x, masks, pack))
        return real_ssm(p, x, *a, masks=masks, pack=pack, **kw)

    monkeypatch.setattr(S, "ssm", record)
    for slot, (prompt, (jl, jc)) in enumerate(zip(prompts, pre)):
        seen.clear()
        tl, tc = tm.lm_prefill_into(w, cfg, tc, {"tokens": torch.from_numpy(prompt).long()},
                                    slot, max_len, masks=masks, pack=pack)
        _close(tl[..., :128], jl[..., :128], f"prefill {slot}", tol)
        assert (tl[..., 128:] == -1e30).all()
        assert len(seen) == cfg.n_layers
        for c, jcl, (p, x, m, pk) in zip(tc, jc, seen):
            with torch.no_grad():
                u = L.linear(p["in_proj"], x, **L.dispatch_kw(cfg, m, "in_proj", pk))
            rows = u[0, -3:, :cfg.ssm_d_inner].to(L.compute_dtype(cfg)).float()
            assert torch.equal(c["ssm"]["conv"][slot], rows), slot
            _close(c["ssm"]["conv"][slot], jcl["ssm"]["conv"][slot], f"conv {slot}", tol)
            _close(c["ssm"]["h"][slot], jcl["ssm"]["h"][slot], f"prefill h {slot}", tol)
    for step, (active, (cur, pos, jl, jc)) in enumerate(zip(actives, steps)):
        frozen = [{k: {n: v.clone() for n, v in c[k].items()} for k in ("kv", "ssm")}
                  for c in tc]
        tl, tc = tm.lm_decode(w, cfg, tc, torch.from_numpy(cur)[:, None].long(),
                              torch.from_numpy(pos).long(), masks=masks, pack=pack,
                              active=torch.from_numpy(active))
        _close(tl[active], jl[active], f"decode {step}", tol)
        for c, f, jcl in zip(tc, frozen, jc):
            if not active[0]:
                for k in ("kv", "ssm"):
                    for n, v in c[k].items():
                        assert torch.equal(v[0], f[k][n][0]), (step, k, n)
            _close(c["ssm"]["h"][1], jcl["ssm"]["h"][1], "decode h", tol)
            _close(c["ssm"]["conv"][1], jcl["ssm"]["conv"][1], "decode conv", tol)


def test_short_prompt_is_refused():
    """A hymba prompt under 3 tokens leaves the reference's conv state
    short (its decode cannot run); the port says so at prefill and at the
    engine's submit."""
    _, cfg, params, masks, pack = _state("block_sparse")
    with pytest.raises(ValueError, match="at least 3 tokens"):
        tm.lm_prefill(params, cfg, {"tokens": torch.zeros(1, 2, dtype=torch.long)}, 16,
                      masks=masks, pack=pack)
    engine = TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack)
    req = t_requests(cfg, 1, prompt_lens=(2,), gen_lens=(4,))[0]
    with pytest.raises(ValueError, match="at least 3 tokens"):
        engine.submit(req)


def _drain(engine):
    while len(engine.queue) or engine.active.any():
        engine.step(now=0.0)
    return engine.stats(0.0)


REQ = dict(prompt_lens=(40, 3), gen_lens=(6, 4, 5))


def test_engine_streams_match_reference_contiguous_and_paged():
    """The reference engine against the port's, contiguous and paged, on
    the same weights and masks (block_sparse): exact-length prefills (a pad
    step would enter the SSM state), the same slots, equal greedy streams.
    The paged engine holds a local ring pool and a global pool; a 40-token
    prompt wraps the smoke window's 16-slot ring; every page comes back."""
    jcfg, cfg, params, masks, pack = _state("block_sparse")
    jreqs = j_requests(jcfg, 4, **REQ)
    jeng = JEngine(jcfg, _jx(params), capacity=2, max_len=48, masks=_jx(masks))
    for r in jreqs:
        assert jeng.submit(r)
    _drain(jeng)
    for paged in (False, True):
        treqs = t_requests(cfg, 4, **REQ)
        eng = TEngine(cfg, params, capacity=2, max_len=48, masks=masks, pack=pack,
                      paged=paged, page_size=8)
        assert eng._padded_len(3) == 3
        if paged:
            assert sorted(eng.pools) == ["global", "local"]
            assert eng.caches[1]["ssm"]["h"].shape[0] == 2
        for r in treqs:
            assert eng.submit(r)
        _drain(eng)
        assert all(r.status is Status.DONE for r in treqs)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs], paged
        assert eng.slot_history == jeng.slot_history
        if paged:
            eng.check_pool_accounting()
            assert all(p.n_live == 0 for p in eng.pools.values())


def test_prefix_cache_refused_for_hymba():
    _, cfg, params, masks, pack = _state("block_sparse")
    with pytest.raises(ValueError, match="recurrent state"):
        TEngine(cfg, params, capacity=2, max_len=32, masks=masks, pack=pack,
                paged=True, prefix_cache=2)


def test_serve_and_train_clis_run_hymba(tmp_path):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import train_loop
    stats = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kernel",
                        "masked", "--paged", "--requests", "3"])
    assert stats["requests"] == 3 and stats["failed"] == 0
    cfg = configure_kernel(t_get_config(ARCH, smoke=True), kernel="block_sparse",
                           block=BLOCK)
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, delta_t=2,
                                                              alpha=0.9))
    state, log = train_loop(cfg, steps=4, batch=2, seq=32, workdir=str(tmp_path),
                            device="cpu", ckpt_every=None, log_every=4)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tpack.validate_pack(state["pack"]) == len(tree_paths(state["masks"]))
    assert int(tpack.pack_mismatch(state["masks"], state["pack"], (BLOCK, BLOCK),
                                   bwd_masks=state["bwd_masks"])) == 0
