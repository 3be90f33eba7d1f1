"""The port's serving engine (``ccsc_code_iccv2017_torch.serve``) against
the JAX ``CodecEngine`` and against the port's own direct solve, on the
CPU, at the JAX serve tests' sizes (tests/test_serve.py): k=6 5x5 bank,
24-32² canvases, max_it 8-20.

Tolerances: port vs JAX engine, recon 1e-4 of max|ref| and obj/PSNR
traces rtol 1e-4 (float32 ADMM iterates whose FFTs and sums run in
another order; tests/test_torch_reconstruct.py holds the direct solves
to the same); a slot of the port's bucket solve vs its own n=1 port
solve 1e-6 relative (the same arithmetic, batched FFTs); the slot-wise
mode with one slot vs the plain path, bit for bit. A padded request is
held on its valid region to 0.05 relative, as the JAX test does
(boundary coupling through the pad).
"""
import importlib
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu.serve import CodecEngine as JEngine
from ccsc_code_iccv2017_tpu.serve import quality as jquality
from ccsc_code_iccv2017_tpu.serve import registry as jregistry
from ccsc_code_iccv2017_torch import serve
from ccsc_code_iccv2017_torch.config import ProblemGeom, ServeConfig, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as tr
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

jr = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")

REC_TOL = 1e-4
TRACE_RTOL = 1e-4
SLOT_TOL = 1e-6


def _bank(k=6, s=5, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfg_kw(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=8, tol=1e-4,
        verbose="none", track_objective=True, track_psnr=True,
    )
    base.update(kw)
    return base


def _req(size, seed=1, keep=0.5):
    r = np.random.default_rng(seed)
    x = r.random((size, size)).astype(np.float32)
    m = (r.random((size, size)) < keep).astype(np.float32)
    return x, m


def _prob(d):
    return tr.ReconstructionProblem(ProblemGeom(d.shape[1:], d.shape[0]))


def _engine(d, cfg_kw, buckets, **kw):
    scfg = ServeConfig(
        buckets=buckets, max_wait_ms=kw.pop("max_wait_ms", 10.0),
        verbose="none", **kw,
    )
    return serve.CodecEngine(d, _prob(d), SolveConfig(**cfg_kw), scfg,
                             device="cpu")


_PATH_FIELDS = ("compile_cache", "artifact_store", "warm_rank_capture",
                "tune_store")


def _unlatched_compile_cache(monkeypatch):
    """Undo, at the test's end, the process-wide latch a compile cache
    sets (the engine's latch and the libraries' build directories)."""
    from ccsc_code_iccv2017_torch.data import native
    from ccsc_code_iccv2017_torch.serve import engine as tengine

    monkeypatch.setattr(tengine, "_compile_cache_path", None)
    monkeypatch.setattr(kernels, "_BUILD_DIR", None)
    monkeypatch.setattr(native, "_BUILD_DIR", None)


def _jax_engine(d, cfg_kw, buckets, **kw):
    geom = jcfg.ProblemGeom(d.shape[1:], d.shape[0])
    return JEngine(
        jnp.asarray(d), jr.ReconstructionProblem(geom),
        jcfg.SolveConfig(**cfg_kw),
        jcfg.ServeConfig(buckets=buckets, max_wait_ms=10.0, verbose="none",
                         **kw),
    )


def _direct(d, cfg_kw, x, m, x_orig=None):
    """The port's own n=1 solve of one request at its exact shape."""
    return tr.reconstruct(
        (x * m)[None], d, _prob(d), SolveConfig(**cfg_kw), mask=m[None],
        x_orig=None if x_orig is None else x_orig[None], device="cpu",
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


# (slots, requests as (seed, keep), cfg): one request in a 2-slot
# bucket, and three requests in a 4-slot bucket that stop at three
# different iterations (13, 12, 14 at tol 0.1), leaving one filler slot
CASES = {
    "one_request": (2, [(1, 0.5)], dict(max_it=8, tol=1e-4)),
    "three_of_four": (4, [(1, 0.5), (3, 0.9), (4, 0.2)],
                      dict(max_it=20, tol=0.1)),
}


def _submit_all(eng, reqs):
    futs = [eng.submit(x * m, mask=m, x_orig=x) for x, m in reqs]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_bucket_matches_jax_engine_and_direct_solve(case):
    """Each request at a bucket's shape, served by the port engine: the
    JAX engine's result on the same inputs to tolerance (recon, traces,
    the same stop iteration), and the port's own direct n=1 solve to
    1e-6 with the same stop; every slot stops at its own iteration."""
    slots, specs, kw = CASES[case]
    d = _bank()
    cfg_kw = _cfg_kw(**kw)
    reqs = [_req(24, seed, keep) for seed, keep in specs]
    launches = kernels.solve_z_rank1.launches
    with _engine(d, cfg_kw, ((slots, (24, 24)),),
                 max_wait_ms=10_000.0 if len(reqs) == slots else 50.0) as eng:
        got = _submit_all(eng, reqs)
        st = eng.stats()
    jeng = _jax_engine(d, cfg_kw, ((slots, (24, 24)),))
    try:
        want = _submit_all(jeng, reqs)
    finally:
        jeng.close()
    # on the CPU the z-solve runs K1's plain version: no launches
    assert kernels.solve_z_rank1.launches == launches
    assert st["n_dispatches"] == 1
    iters = [int(g.trace.num_iters) for g in got]
    assert eng.dispatch_iters == [max(iters)]
    if len(reqs) > 1:
        assert len(set(iters)) == len(reqs), iters
    for (x, m), g, w in zip(reqs, got, want):
        n = int(w.trace.num_iters)
        assert int(g.trace.num_iters) == n
        scale = float(np.abs(w.recon).max())
        assert float(np.abs(g.recon - w.recon).max()) <= REC_TOL * scale
        for name in ("obj_vals", "psnr_vals"):
            np.testing.assert_allclose(
                getattr(g.trace, name)[: n + 1],
                np.asarray(getattr(w.trace, name))[: n + 1],
                rtol=TRACE_RTOL, err_msg=name,
            )
            # a stopped slot is frozen: its later trace entries stay 0
            assert not getattr(g.trace, name)[n + 1:].any(), name
        assert g.psnr == pytest.approx(w.psnr, abs=1e-3)
        one = _direct(d, cfg_kw, x, m, x_orig=x)
        assert int(one.trace.num_iters) == n
        assert _rel(g.recon, one.recon[0].numpy()) <= SLOT_TOL
        np.testing.assert_allclose(
            g.trace.obj_vals, one.trace.obj_vals.numpy(), rtol=SLOT_TOL,
        )


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(storage_dtype="bfloat16"), dict(track_diagnostics=True),
     dict(track_psnr=False, max_it=3, tol=0.0)],
    ids=["f32", "bf16", "diagnostics", "untracked"],
)
def test_slotwise_one_slot_is_bitwise_the_plain_path(kw):
    """The slot-wise mode with one slot computes the plain path's bits:
    recon, codes, every trace, the stop iteration and the extras."""
    d = _bank()
    cfg = SolveConfig(**_cfg_kw(**kw))
    x, m = _req(24, seed=5)
    sm = 0.5 * np.ones_like(x)
    args = [torch.from_numpy(a[None]) for a in (x * m, m, sm, x)]
    b, mask, smooth, xo = args
    plain = tr._reconstruct_impl(b, torch.from_numpy(d), _prob(d), cfg,
                                 mask, smooth, None, xo)
    slot = tr._reconstruct_impl(b, torch.from_numpy(d), _prob(d), cfg,
                                mask, smooth, None, xo, slotwise=True)
    assert torch.equal(slot.recon, plain.recon)
    assert torch.equal(slot.z, plain.z)
    for name in ("obj_vals", "psnr_vals", "diff_vals"):
        assert torch.equal(getattr(slot.trace, name)[0],
                           getattr(plain.trace, name)), name
    assert slot.trace.num_iters.tolist() == [plain.trace.num_iters]
    if cfg.track_diagnostics:
        for a, p in zip(slot.trace.extras, plain.trace.extras):
            assert torch.equal(a[0], p), (a, p)


def test_filler_slots_stop_after_one_iteration_and_stay_finite():
    """A bucket of zero data and zero masks (every slot a filler):
    gamma clamps to ~1e32, everything stays finite and each slot stops
    after its first iteration, holding nothing open."""
    d = _bank()
    cfg = SolveConfig(**_cfg_kw(max_it=8, tol=1e-4))
    z = torch.zeros(3, 24, 24)
    res = tr._reconstruct_impl(z, torch.from_numpy(d), _prob(d), cfg, z, z,
                               None, z, slotwise=True)
    assert res.trace.num_iters.tolist() == [1, 1, 1]
    assert torch.isfinite(res.recon).all() and torch.isfinite(res.z).all()
    assert torch.isfinite(res.trace.obj_vals).all()


def test_padded_bucket_matches_exact_shape_on_valid_region():
    d = _bank()
    cfg_kw = _cfg_kw(max_it=20)
    x, m = _req(26, seed=3)
    with _engine(d, cfg_kw, ((2, (32, 32)),)) as eng:
        res = eng.reconstruct(x * m, mask=m)
    assert res.bucket == "2@32x32"
    assert res.recon.shape == (26, 26)
    assert res.psnr is None
    ref = _direct(d, cfg_kw, x, m).recon[0].numpy()
    assert _rel(res.recon, ref) < 0.05


def test_requests_without_optional_fields_match_direct_none_path():
    """mask/smooth_init/x_orig None: the engine's neutral fills (ones
    mask, zero offset) run the direct call's None path."""
    d = _bank()
    cfg_kw = _cfg_kw()
    x, _ = _req(24, seed=7)
    with _engine(d, cfg_kw, ((2, (24, 24)),)) as eng:
        res = eng.reconstruct(x)
    direct = tr.reconstruct(x[None], d, _prob(d), SolveConfig(**cfg_kw),
                            device="cpu")
    assert _rel(res.recon, direct.recon[0].numpy()) <= SLOT_TOL
    assert res.psnr is None
    assert not res.trace.psnr_vals.any()


def test_queue_flushes_at_slots():
    d = _bank()
    with _engine(d, _cfg_kw(), ((2, (24, 24)),),
                 max_wait_ms=10_000.0) as eng:
        x, m = _req(24)
        t0 = time.perf_counter()
        futs = [eng.submit(x * m, mask=m) for _ in range(2)]
        for f in futs:
            f.result(timeout=60)
        assert time.perf_counter() - t0 < 10.0  # did not sit out 10 s
        st = eng.stats()
    assert st["n_dispatches"] == 1
    assert st["mean_occupancy"] == 1.0


def test_queue_flushes_at_max_wait():
    d = _bank()
    wait_ms = 150.0
    with _engine(d, _cfg_kw(), ((4, (24, 24)),), max_wait_ms=wait_ms) as eng:
        x, m = _req(24)
        res = eng.submit(x * m, mask=m).result(timeout=60)
        st = eng.stats()
    assert res.wait_s >= 0.8 * wait_ms / 1e3
    assert st["n_dispatches"] == 1 and st["mean_occupancy"] == 0.25


def test_full_bucket_stream_does_not_starve_deadline():
    """A stream keeping one bucket full must not starve another
    bucket's lone request past its max_wait: the oldest lane flushes
    first."""
    d = _bank()
    wait_ms = 100.0
    with _engine(d, _cfg_kw(max_it=4), ((1, (20, 20)), (4, (32, 32))),
                 max_wait_ms=wait_ms) as eng:
        xs, ms = _req(20)
        xb, mb = _req(30, seed=9)
        lone = eng.submit(xb * mb, mask=mb)
        small = [eng.submit(xs * ms, mask=ms) for _ in range(8)]
        res = lone.result(timeout=60)
        assert res.wait_s < 8 * wait_ms / 1e3, res.wait_s
        for f in small:
            f.result(timeout=60)


def test_bucket_selection_and_oversize_refusal():
    d = _bank()
    with _engine(d, _cfg_kw(), ((2, (40, 40)), (2, (24, 24)))) as eng:
        assert eng.buckets == [(2, (24, 24)), (2, (40, 40))]
        assert eng.bucket_for((20, 24)) == (2, (24, 24))
        assert eng.bucket_for((25, 10)) == (2, (40, 40))
        with pytest.raises(CCSCInputError, match="exceeds every"):
            eng.bucket_for((64, 64))
        x, m = _req(64)
        with pytest.raises(CCSCInputError, match="exceeds every"):
            eng.submit(x * m, mask=m)
    assert serve.pick_bucket(((1, (8, 8)),), (8, 8)) == (1, (8, 8))


def test_per_request_validation_is_the_cheap_subset():
    d = _bank()
    with _engine(d, _cfg_kw(), ((2, (24, 24)),)) as eng:
        x, m = _req(24)
        bad = x.copy()
        bad[3, 3] = np.nan
        with pytest.raises(CCSCInputError, match="non-finite"):
            eng.submit(bad)
        with pytest.raises(CCSCInputError, match="no batch axis"):
            eng.submit(x[None])
        with pytest.raises(CCSCInputError, match="mask shape"):
            eng.submit(x, mask=m[:12])
        with pytest.raises(CCSCInputError, match="identically zero"):
            eng.submit(x, mask=np.zeros_like(m))
        with pytest.raises(CCSCInputError, match="unknown bank id"):
            eng.submit(x, bank_id="nope")
    bad_bank = _bank()
    bad_bank[0, 0, 0] = np.inf
    with pytest.raises(CCSCInputError, match="non-finite"):
        _engine(bad_bank, _cfg_kw(), ((2, (24, 24)),))


def test_expired_deadlines_are_refused():
    """At submit (already expired) and in the queue (expired while
    waiting for its lane to fill: swept before it costs a slot, and the
    flush wait is capped at the deadline)."""
    d = _bank()
    with _engine(d, _cfg_kw(), ((4, (24, 24)),),
                 max_wait_ms=60_000.0) as eng:
        x, m = _req(24)
        with pytest.raises(serve.DeadlineExceeded) as exc:
            eng.submit(x * m, mask=m, deadline_ms=0.0)
        assert exc.value.where == "engine"
        t0 = time.perf_counter()
        fut = eng.submit(x * m, mask=m, deadline_ms=100.0)
        with pytest.raises(serve.DeadlineExceeded) as exc:
            fut.result(timeout=30)
        assert exc.value.where == "dispatch"
        assert time.perf_counter() - t0 < 30.0  # not the 60 s flush
        assert eng.stats()["n_dispatches"] == 0


@pytest.mark.parametrize(
    "kw",
    [dict(tenant="t"), dict(_validated=True), dict(_trace=("t", None)),
     dict(_digest="0" * 16), dict(_deadline=1e12)],
    ids=lambda kw: next(iter(kw)),
)
def test_fleet_only_submit_fields_raise(kw):
    """The fleet-internal submit fields are served since the fleet
    slice: each is accepted and serves the plain submit's bits; only a
    value the fleet contract refuses raises (a digest this engine never
    published)."""
    d = _bank()
    with _engine(d, _cfg_kw(), ((2, (24, 24)),), max_wait_ms=0.0) as eng:
        x, m = _req(24)
        ref = eng.submit(x * m, mask=m).result(timeout=60)
        if "_digest" in kw:
            with pytest.raises(CCSCInputError, match="not published"):
                eng.submit(x * m, mask=m, **kw)
            kw = {"_digest": eng.bank_digest()}
        res = eng.submit(x * m, mask=m, **kw).result(timeout=60)
    np.testing.assert_array_equal(res.recon, ref.recon)


def test_close_idempotent_reentrant_and_closed_property():
    d = _bank()
    eng = _engine(d, _cfg_kw(max_it=4), ((2, (24, 24)),))
    assert eng.closed is False
    x, m = _req(24)
    fut = eng.submit(x * m, mask=m)
    done = []
    threads = [
        threading.Thread(target=lambda: (eng.close(), done.append(1)))
        for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert done == [1, 1, 1]
    assert eng.closed is True
    assert not eng._worker.is_alive()
    # the pre-close request was flushed, not dropped
    assert fut.result(timeout=5).recon.shape == (24, 24)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(x * m, mask=m)


def test_close_noop_when_constructor_failed():
    d = _bank()
    eng = serve.CodecEngine.__new__(serve.CodecEngine)
    with pytest.raises(CCSCInputError, match="smaller than the"):
        eng.__init__(d, _prob(d), SolveConfig(**_cfg_kw()),
                     ServeConfig(buckets=((2, (4, 4)),), verbose="none"),
                     device="cpu")
    eng.close()
    eng.close()
    assert eng.drain_pending() == []


def test_drain_pending_hands_off_queued_requests():
    d = _bank()
    with _engine(d, _cfg_kw(), ((2, (24, 24)),),
                 max_wait_ms=60_000.0) as eng:
        x, m = _req(24)
        fut = eng.submit(x * m, mask=m)
        taken = eng.drain_pending()
        assert len(taken) == 1
        assert fut.cancelled()
        np.testing.assert_array_equal(taken[0]["b"], x * m)
        np.testing.assert_array_equal(taken[0]["mask"], m)
        assert taken[0]["digest"] == eng.bank_digest()
        assert eng.drain_pending() == []


def test_set_max_wait_ms_live_retarget():
    d = _bank()
    with _engine(d, _cfg_kw(max_it=4), ((2, (24, 24)),),
                 max_wait_ms=60_000.0) as eng:
        x, m = _req(24)
        t0 = time.perf_counter()
        fut = eng.submit(x * m, mask=m)
        eng.set_max_wait_ms(0.0)
        assert fut.result(timeout=60).recon.shape == (24, 24)
        assert time.perf_counter() - t0 < 30.0


def test_cancelled_future_does_not_poison_batch():
    d = _bank()
    with _engine(d, _cfg_kw(max_it=4), ((2, (24, 24)),),
                 max_wait_ms=300.0) as eng:
        x, m = _req(24)
        f1 = eng.submit(x * m, mask=m)
        assert f1.cancel()
        f2 = eng.submit(x * m, mask=m)
        f3 = eng.submit(x * m, mask=m)
        assert f2.result(timeout=60).recon.shape == (24, 24)
        assert f3.result(timeout=60).recon.shape == (24, 24)
        assert f1.cancelled()


def test_publish_bank_hot_swaps_and_retires_the_old_digest():
    d1, d2 = _bank(seed=0), _bank(seed=1)
    cfg_kw = _cfg_kw()
    x, m = _req(24)
    with _engine(d1, cfg_kw, ((2, (24, 24)),)) as eng:
        old_digest = eng.bank_digest()
        assert old_digest == jregistry.bank_digest(jnp.asarray(d1))
        before = eng.reconstruct(x * m, mask=m)
        old, new = eng.publish_bank(None, d2)
        assert (old, new) == (old_digest, serve.bank_digest(d2))
        assert eng.bank_digest() == new
        after = eng.reconstruct(x * m, mask=m)
        stats = eng.plan_cache_stats()
    assert stats["n_plans"] == 1  # the superseded digest was retired
    assert _rel(before.recon, _direct(d1, cfg_kw, x, m).recon[0]) <= SLOT_TOL
    assert _rel(after.recon, _direct(d2, cfg_kw, x, m).recon[0]) <= SLOT_TOL


def test_retire_bank_refused_while_routed():
    d1, d2, d3 = (_bank(seed=s) for s in (0, 1, 2))
    x, m = _req(24)
    with _engine(d1, _cfg_kw(max_it=4), ((2, (24, 24)),)) as eng:
        _, dg2 = eng.publish_bank("alt", d2)
        assert eng.bank_ids == ["alt"]
        assert eng.retire_bank(dg2) is False  # routed by "alt"
        assert eng.retire_bank(eng.bank_digest()) is False  # the default
        res = eng.reconstruct(x * m, mask=m, bank_id="alt")
        dg3 = eng.add_bank(d3)
        assert eng.retire_bank(dg3) is True  # added, never routed
        assert eng.plan_cache_stats()["n_plans"] == 2
        with pytest.raises(CCSCInputError, match="per-bank blur"):
            eng.add_bank(d3, blur_psf=np.ones((3, 3), np.float32))
    assert _rel(res.recon,
                _direct(d2, _cfg_kw(max_it=4), x, m).recon[0]) <= SLOT_TOL


def test_plan_cache_lru_budget_pin_and_drop():
    d = _bank()
    plan = tr.build_plan(d, _prob(d), SolveConfig(**_cfg_kw()), (24, 24),
                         device="cpu")
    nb = serve.registry.plan_nbytes(plan)
    assert nb == sum(t.numel() * t.element_size() for t in (
        plan.dhat_clean, plan.kern.dinv, plan.kern.minv_diag))
    cache = serve.PlanCache(max_bytes=2 * nb)
    assert cache.put("a", 1, plan) == []
    assert cache.put("b", 1, plan) == []
    assert cache.get("a", 1) is plan  # "a" is now the newest
    assert cache.put("c", 1, plan, pin={"b"}) == [("a", 1)]
    assert cache.put("d", 1, plan) == [("b", 1)]
    assert cache.get("a", 1) is None
    assert cache.drop_digest("c") == [("c", 1)]
    assert cache.stats() == {
        "n_plans": 1, "plan_bytes": nb, "max_bytes": 2 * nb, "hits": 1,
        "misses": 1, "evictions": 3,
        # the JAX stats' measured watermark: no card, not measured
        "measured_peak_hbm_bytes": None,
    }


def test_valid_region_psnr_matches_jax():
    r = np.random.default_rng(0)
    rec, ref = r.random((2, 30, 28)), r.random((2, 30, 28))
    assert serve.valid_region_psnr(rec, ref, (2, 3)) == \
        jquality.valid_region_psnr(rec, ref, (2, 3))


@pytest.mark.parametrize(
    "kw, item",
    [
        # served since the knobs slice (tests/test_torch_serve_pipeline.py,
        # tests/test_torch_autotune.py): tuning against an empty store
        # runs the defaults
        (dict(tune="auto"), "served"),
        (dict(tune_store="tuned.json"), "served"),
        (dict(pipeline_depth=2), "served"),
        # capture runs since the robustness slice (serve.capture)
        (dict(capture_dir="c"), None),
        # served since the warmup slice: the library build directory,
        # the library store, staged warmup and its ordering
        (dict(compile_cache="cc"), "served"),
        (dict(artifact_store="a"), "served"),
        # served since the fleet slice: every record carries it
        (dict(replica_id=0), "served"),
        (dict(staged_warmup=True), "served"),
        (dict(warm_order=("2@24x24",)), "served"),
        (dict(warm_rank_capture="c"), "served"),
    ],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else str(v),
)
def test_deferred_serve_fields_raise_naming_roadmap(kw, item, tmp_path,
                                                     monkeypatch):
    buckets = ((2, (24, 24)),)
    jcfg.ServeConfig(buckets=buckets, **kw)  # valid in the JAX package
    if item == "served":
        _unlatched_compile_cache(monkeypatch)
        # a tuning engine reads an empty store of its own
        monkeypatch.setenv("CCSC_TUNE_STORE", str(tmp_path / "store.json"))
        kw = {k: (str(tmp_path / v) if k in _PATH_FIELDS else v)
              for k, v in kw.items()}
        d = _bank()
        mdir = str(tmp_path / "m")
        with _engine(d, _cfg_kw(max_it=2), buckets, metrics_dir=mdir,
                     **kw) as eng:
            x, m = _req(24)
            eng.submit(x * m, mask=m).result(timeout=60)
        from ccsc_code_iccv2017_torch.utils import obs

        ev = obs.read_events(mdir)
        recs = [r for r in ev if r.get("type", "").startswith("serve_")]
        assert recs and all(r["replica_id"] == kw.get("replica_id")
                            for r in recs)
        (ready,) = [r for r in ev if r["type"] == "serve_ready"]
        (stage,) = [r for r in ev if r["type"] == "warmup_stage"]
        assert (stage["stage"], stage["bucket"], stage["source"]) == (
            1, "2@24x24", "compiled")
        assert ready["staged"] is bool(kw.get("staged_warmup"))
        assert eng.cache_dir == kw.get("compile_cache")
        if "compile_cache" in kw:
            assert kernels.build_dir() == kw["compile_cache"]
        if "artifact_store" in kw:
            # on the CPU the engine loads no library: the store stays
            # untouched
            assert not os.path.exists(kw["artifact_store"])
        return
    if item is None:
        # constructs, and a standalone engine records its requests there
        cap = str(tmp_path / kw["capture_dir"])
        d = _bank()
        with _engine(d, _cfg_kw(max_it=2), buckets,
                     **dict(kw, capture_dir=cap)) as eng:
            x, m = _req(24)
            eng.submit(x * m, mask=m).result(timeout=60)
        from ccsc_code_iccv2017_torch.serve import capture

        assert [w["bucket"] for w in capture.read_workload(cap)] == [
            "2@24x24"]
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item}"):
        ServeConfig(buckets=buckets, **kw)


# -- staged warmup and the compile-cache latch (JAX tests/test_serve.py,
# "staged warmup + compile-cache latch")


def _wait_warm(eng, key, timeout=120.0):
    deadline = time.time() + timeout
    while not eng.bucket_warm(key):
        assert time.time() < deadline, f"bucket {key} never warmed"
        time.sleep(0.02)


def test_staged_warmup_serves_hot_bucket_while_cold_builds(tmp_path):
    """The JAX staged contract on the port: the constructor returns once
    the DECLARED-hot bucket is warm; a request for the still-cold bucket
    is refused with BucketCold (retry-after), the hot bucket serves at
    once, the cold one warms in the background and then serves; stages
    read [1, 2]. Both results equal the JAX staged engine's within
    REC_TOL."""
    d = _bank(k=4, s=3)
    cfg_kw = _cfg_kw(max_it=3, tol=0.0)
    buckets = ((2, (48, 48)), (2, (16, 16)))
    staged = dict(staged_warmup=True, warm_order=("2@16x16",))
    mdir = str(tmp_path / "m")
    xc, mc = _req(48, seed=3)
    x, m = _req(16, seed=2)
    eng = _engine(d, cfg_kw, buckets, metrics_dir=mdir, **staged)
    try:
        assert eng.bucket_warm((2, (16, 16)))
        refused = None
        if not eng.bucket_warm((2, (48, 48))):
            with pytest.raises(serve.BucketCold) as exc:
                eng.submit(xc * mc, mask=mc, x_orig=xc)
            refused = exc.value
            assert refused.bucket == "2@48x48"
            assert refused.retry_after_s > 0
        res = eng.submit(x * m, mask=m, x_orig=x).result(timeout=120)
        assert res.bucket == "2@16x16"
        _wait_warm(eng, (2, (48, 48)))
        resc = eng.submit(xc * mc, mask=mc, x_orig=xc).result(timeout=120)
        assert resc.bucket == "2@48x48"
    finally:
        eng.close()
    from ccsc_code_iccv2017_torch.utils import obs

    ev = obs.read_events(mdir)
    stages = [e for e in ev if e["type"] == "warmup_stage"]
    assert [e["stage"] for e in stages] == [1, 2]
    assert [e["bucket"] for e in stages] == ["2@16x16", "2@48x48"]
    (ready,) = [e for e in ev if e["type"] == "serve_ready"]
    assert ready["staged"] is True
    assert ready["first_ready_s"] <= ready["warmup_s"]
    cold = [e for e in ev if e["type"] == "bucket_cold"]
    assert len(cold) == (refused is not None)

    jeng = _jax_engine(d, cfg_kw, buckets, **staged)
    try:
        _wait_warm(jeng, (2, (48, 48)), timeout=240)
        jres = jeng.submit(x * m, mask=m, x_orig=x).result(timeout=240)
        jresc = jeng.submit(xc * mc, mask=mc,
                            x_orig=xc).result(timeout=240)
    finally:
        jeng.close()
    assert _rel(res.recon, jres.recon) <= REC_TOL
    assert _rel(resc.recon, jresc.recon) <= REC_TOL


def test_staged_warm_order_typo_refused():
    d = _bank(k=4, s=3)
    kw = dict(staged_warmup=True, warm_order=("2@99x99",))
    with pytest.raises(CCSCInputError, match="not.*configured"):
        _engine(d, _cfg_kw(max_it=3), ((2, (16, 16)),), **kw)
    from ccsc_code_iccv2017_tpu.utils.validate import (
        CCSCInputError as JInputError,
    )

    with pytest.raises(JInputError, match="not.*configured"):
        _jax_engine(d, _cfg_kw(max_it=3), ((2, (16, 16)),), **kw)


def test_enable_compile_cache_latch_warns_on_different_path(tmp_path):
    """The per-process build-directory latch: a SECOND enable with a
    DIFFERENT path warns on the console (tier always) and keeps the
    first, which the libraries' build directories follow. In a
    subprocess: the latch is process-global by design."""
    import subprocess
    import sys

    a, b = str(tmp_path / "cc-a"), str(tmp_path / "cc-b")
    code = f"""
from ccsc_code_iccv2017_torch.data import native
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.serve import enable_compile_cache
assert enable_compile_cache(None) is None
assert enable_compile_cache({a!r}) == {a!r}
assert enable_compile_cache({b!r}) == {a!r}
assert enable_compile_cache({a!r}) == {a!r}  # same path: silent
assert kernels.build_dir() == native.build_dir() == {a!r}
"""
    env = dict(os.environ)
    env.pop("CCSC_COMPILE_CACHE", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    warns = [ln for ln in p.stdout.splitlines() if "already latched" in ln]
    assert len(warns) == 1, p.stdout
    assert "ignoring the new path" in warns[0]
    assert not os.path.exists(b)


def test_warmup_stages_count_from_one_like_jax(tmp_path):
    """A non-staged engine's ``warmup_stage`` records number the
    stages 1..n in warm order, as the JAX engine's do on the same
    buckets."""
    d = _bank(k=4, s=3)
    cfg_kw = _cfg_kw(max_it=2)
    buckets = ((2, (12, 12)), (2, (16, 16)), (2, (20, 20)))
    stages = {}
    for pkg, make in (("port", _engine), ("jax", None)):
        mdir = str(tmp_path / pkg)
        if make is None:
            geom = jcfg.ProblemGeom(d.shape[1:], d.shape[0])
            eng = JEngine(jnp.asarray(d), jr.ReconstructionProblem(geom),
                          jcfg.SolveConfig(**cfg_kw),
                          jcfg.ServeConfig(buckets=buckets, metrics_dir=mdir,
                                           verbose="none"))
            from ccsc_code_iccv2017_tpu.utils import obs as readers
        else:
            eng = make(d, cfg_kw, buckets, metrics_dir=mdir)
            from ccsc_code_iccv2017_torch.utils import obs as readers
        eng.close()
        stages[pkg] = [(e["stage"], e["n_stages"], e["bucket"])
                       for e in readers.read_events(mdir)
                       if e["type"] == "warmup_stage"]
    assert stages["port"] == stages["jax"] == [
        (1, 3, "2@12x12"), (2, 3, "2@16x16"), (3, 3, "2@20x20")]


def test_engine_on_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = _bank()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.CodecEngine(d, _prob(d), SolveConfig(**_cfg_kw()),
                          ServeConfig(buckets=((2, (24, 24)),)))


def test_return_codes_and_stats():
    d = _bank()
    with _engine(d, _cfg_kw(max_it=4), ((2, (24, 24)),),
                 return_codes=True) as eng:
        x, m = _req(20)
        res = eng.reconstruct(x * m, mask=m, x_orig=x)
        st = eng.stats()
        assert eng.dispatch_iters == [int(res.trace.num_iters)]
    assert res.z.shape == (6, 28, 28)  # the bucket's padded code canvas
    assert res.psnr == pytest.approx(
        serve.valid_region_psnr(res.recon, x, (2, 2)))
    assert st["n_requests"] == 1
    # one request: both percentiles are the histogram's largest
    # observation, its milliseconds, back in seconds
    assert st["p50_latency_s"] == st["p99_latency_s"] == \
        res.latency_s * 1e3 / 1e3


def test_engine_on_card_launches_k1_once_per_iteration():
    """On the card the bucket solve launches K1 once per iteration for
    all slots, and agrees with the CPU engine (card-only: K1 has no CPU
    mode; chip_smoke.py phase 10 drives it at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    d = _bank()
    slots, specs, kw = CASES["three_of_four"]
    cfg_kw = _cfg_kw(**kw)
    reqs = [_req(24, seed, keep) for seed, keep in specs]
    scfg = ServeConfig(buckets=((slots, (24, 24)),), max_wait_ms=50.0,
                       verbose="none")
    with serve.CodecEngine(d, _prob(d), SolveConfig(**cfg_kw), scfg,
                           device="cuda") as eng:
        kernels.solve_z_rank1.launches = 0
        got = _submit_all(eng, reqs)
        assert kernels.solve_z_rank1.launches == sum(eng.dispatch_iters)
    with _engine(d, cfg_kw, ((slots, (24, 24)),), max_wait_ms=50.0) as eng:
        want = _submit_all(eng, reqs)
    for g, w in zip(got, want):
        assert int(g.trace.num_iters) == int(w.trace.num_iters)
        assert _rel(g.recon, w.recon) <= REC_TOL


def test_bench_record_over_full_dispatches():
    """serve/bench.py's record: the window's rate, the rate over the
    dispatches that filled every slot (their requests over their summed
    wall, from the engine's dispatch log), and latency p50 <= p90 <= max
    over every served request."""
    from ccsc_code_iccv2017_torch.serve import bench

    d = _bank()
    cfg_kw = _cfg_kw(max_it=4)
    reqs = bench.make_requests([24] * 5 + [20] * 2, seed=3)
    with _engine(d, cfg_kw, ((2, (24, 24)),), max_wait_ms=50.0) as eng:
        served, engine_s, submit_s = bench.run_engine(eng, reqs)
        looped, loop_s = bench.run_direct_loop(
            d, _prob(d), SolveConfig(**cfg_kw), reqs, "cpu")
        rec = bench.record(eng, served, engine_s, submit_s, looped, loop_s,
                           "cpu")
        log = eng.dispatch_log
    assert sum(rec["dispatch_requests"]) == rec["requests"] == 7
    assert 0 < rec["submit_wall_s"] <= rec["engine_wall_s"]
    assert rec["dispatch_iters"] == eng.dispatch_iters
    full = [e for e in log if e["requests"] == 2]
    assert rec["full_dispatches"] == len(full) >= 1
    assert rec["full_dispatch_requests_per_sec"] == pytest.approx(
        2 * len(full) / sum(e["wall_s"] for e in full))
    lat = sorted(1e3 * s.latency_s for s in served)
    assert rec["p50_ms"] <= rec["p90_ms"] <= rec["max_ms"] == lat[-1]
    # the exact-shape requests stop where their direct calls do
    assert rec["served_iters"][:5] == rec["loop_iters"][:5]
    assert rec["max_rel_err_vs_loop"] < 0.05
    assert rec["device"] == "cpu"
