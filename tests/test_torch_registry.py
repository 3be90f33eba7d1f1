"""The port's bank registry (``ccsc_code_iccv2017_torch.serve.registry``)
and the engine/fleet hot swap, on the CPU, against the JAX package
(tests/test_registry.py's tiny problem: k=4 3x3 banks, a 2-slot 12x12
bucket, max_it 3).

Contracts under test:
- BankRegistry: durable manifests (latest wins, history kept,
  torn-tail tolerant), content-addressed bank store, corrupt-payload
  refusal; the on-disk format is the JAX package's, so each package
  reads a registry the other wrote, and the digest is JAX's for the
  same float32 bank (the ``d_digest`` plans carry in both);
- PlanCache: byte-budgeted LRU with pinning, evict-and-rebuild;
- CodecEngine multi-bank routing and hot swap: results bit-identical
  to fresh single-bank engines, the cutover a ``bank_swap`` record;
- the fleet hot swap mid-stream: zero lost requests, pre-swap results
  bitwise on the old bank and post-swap on the new, within REC_TOL
  (1e-4 of max|ref|, tests/test_torch_serve.py) of the JAX fleet's;
  a restarted replica republishes every bank.
"""
import os
import time

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu import serve as jserve
from ccsc_code_iccv2017_tpu.serve import registry as jregistry
from ccsc_code_iccv2017_torch.config import (
    FleetConfig,
    ProblemGeom,
    ServeConfig,
    SolveConfig,
    TenantSpec,
)
from ccsc_code_iccv2017_torch.models.reconstruct import (
    ReconstructionProblem,
    build_plan,
)
from ccsc_code_iccv2017_torch.serve import (
    BankRegistry,
    PlanCache,
    bank_digest,
)
from ccsc_code_iccv2017_torch.serve import CodecEngine as _Engine
from ccsc_code_iccv2017_torch.serve import ServeFleet as _Fleet
from ccsc_code_iccv2017_torch.serve import registry as registry_mod
from ccsc_code_iccv2017_torch.utils import obs
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

REC_TOL = 1e-4


def CodecEngine(*a, **kw):
    return _Engine(*a, device="cpu", **kw)


def ServeFleet(*a, **kw):
    return _Fleet(*a, device="cpu", **kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def _bank(seed=0, k=4, s=3):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfg(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_objective=True,
    )
    base.update(kw)
    return SolveConfig(**base)


def _scfg(**kw):
    base = dict(
        buckets=((2, (12, 12)),), max_wait_ms=2.0, verbose="none"
    )
    base.update(kw)
    return ServeConfig(**base)


def _geom(d):
    return ProblemGeom(d.shape[1:], d.shape[0])


def _req(seed=1, size=12, keep=0.5):
    r = np.random.default_rng(seed)
    x = r.random((size, size)).astype(np.float32)
    m = (r.random((size, size)) < keep).astype(np.float32)
    return x * m, m


# ---------------------------------------------------------------------
# BankRegistry
# ---------------------------------------------------------------------


def test_registry_publish_resolve_roundtrip(tmp_path):
    reg = BankRegistry(str(tmp_path))
    d0, d1 = _bank(0), _bank(1)
    man0 = reg.publish("bank-a", d0, tenant="alpha")
    assert man0["digest"] == bank_digest(d0)
    assert man0["geometry"]["num_filters"] == 4
    assert man0["geometry"]["spatial_support"] == [3, 3]
    # latest wins: a re-publish under a new digest IS the swap trigger
    man1 = reg.publish("bank-a", d1)
    got = reg.resolve("bank-a")
    assert got["digest"] == man1["digest"] == bank_digest(d1)
    assert [m["digest"] for m in reg.history("bank-a")] == [
        man0["digest"], man1["digest"],
    ]
    arr, man = reg.load("bank-a")
    np.testing.assert_array_equal(arr, d1)
    reg.close()


def test_registry_digest_is_the_plan_refusal_digest(tmp_path):
    """Registry identity and ReconPlan's d_digest are the SAME
    fingerprint — routing and plan refusal can never disagree about
    what a bank is."""
    d = _bank(3)
    reg = BankRegistry(str(tmp_path))
    man = reg.publish("b", d)
    plan = build_plan(
        d, ReconstructionProblem(_geom(d)), _cfg(),
        (12, 12), device="cpu",
    )
    assert plan.d_digest == man["digest"]
    assert man["digest"] == jregistry.bank_digest(jnp.asarray(d))
    reg.close()


def test_registry_unknown_and_reopen(tmp_path):
    reg = BankRegistry(str(tmp_path))
    with pytest.raises(CCSCInputError, match="not in the registry"):
        reg.resolve("missing")
    reg.publish("b", _bank(0))
    reg.close()
    # a reopened registry continues the sequence durably
    reg2 = BankRegistry(str(tmp_path))
    man = reg2.publish("b", _bank(1))
    assert man["seq"] == 2
    assert len(reg2.history("b")) == 2
    reg2.close()


def test_registry_torn_manifest_tail_is_dropped(tmp_path):
    reg = BankRegistry(str(tmp_path))
    reg.publish("b", _bank(0))
    reg.close()
    # simulate a writer killed mid-append: torn trailing line
    with open(
        os.path.join(str(tmp_path), "manifest.jsonl"), "a"
    ) as f:
        f.write('{"bank_id": "b", "digest": "dead')
    reg2 = BankRegistry(str(tmp_path))
    assert len(reg2.history("b")) == 1  # torn line dropped, not fatal
    reg2.close()


def test_registry_corrupt_payload_refused(tmp_path):
    reg = BankRegistry(str(tmp_path))
    man = reg.publish("b", _bank(0))
    # corrupt the stored bytes behind the manifest's back
    np.save(os.path.join(str(tmp_path), man["path"]), _bank(9))
    with pytest.raises(CCSCInputError, match="does not match"):
        reg.load("b")
    reg.close()


# ---------------------------------------------------------------------
# PlanCache
# ---------------------------------------------------------------------


def _tiny_plan(seed, spatial=(12, 12)):
    d = _bank(seed)
    return build_plan(
        d, ReconstructionProblem(_geom(d)), _cfg(),
        spatial, device="cpu",
    )


def test_plan_cache_lru_eviction_and_pinning():
    p0, p1, p2 = (_tiny_plan(i) for i in range(3))
    one = registry_mod.plan_nbytes(p0)
    assert one > 0
    cache = PlanCache(max_bytes=2 * one)
    assert cache.put("d0", "bk", p0) == []
    assert cache.put("d1", "bk", p1) == []
    cache.get("d0", "bk")  # touch: d1 becomes the LRU victim
    evicted = cache.put("d2", "bk", p2)
    assert evicted == [("d1", "bk")]
    assert cache.get("d1", "bk") is None  # miss -> caller rebuilds
    assert cache.get("d0", "bk") is not None
    # pinned digests survive over-budget inserts
    cache2 = PlanCache(max_bytes=one)
    cache2.put("d0", "bk", p0)
    evicted = cache2.put("d1", "bk", p1, pin={"d0"})
    assert evicted == []  # nothing evictable: d0 pinned, d1 just added
    st = cache2.stats()
    assert st["n_plans"] == 2 and st["plan_bytes"] > st["max_bytes"]


def test_plan_cache_stats_count_hits_misses():
    cache = PlanCache(max_bytes=10**9)
    p = _tiny_plan(0)
    cache.put("d", "bk", p)
    assert cache.get("d", "bk") is not None
    assert cache.get("other", "bk") is None
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1


# ---------------------------------------------------------------------
# Engine: multi-bank routing + hot-swap
# ---------------------------------------------------------------------


def test_engine_routes_by_bank_id_bit_identical(tmp_path):
    dA, dB = _bank(0), _bank(1)
    geom = _geom(dA)
    eng = CodecEngine(
        dA, ReconstructionProblem(geom), _cfg(), _scfg()
    )
    try:
        eng.publish_bank("bank-b", dB)
        b, m = _req(5)
        got_a = eng.reconstruct(b, mask=m)  # default bank
        got_b = eng.reconstruct(b, mask=m, bank_id="bank-b")
        with pytest.raises(CCSCInputError, match="unknown bank id"):
            eng.submit(b, mask=m, bank_id="nope")
        assert eng.bank_ids == ["bank-b"]
        assert eng.bank_digest("bank-b") == bank_digest(dB)
    finally:
        eng.close()
    for d_ref, got in ((dA, got_a), (dB, got_b)):
        ref_eng = CodecEngine(
            d_ref, ReconstructionProblem(geom), _cfg(),
            _scfg(),
        )
        try:
            want = ref_eng.reconstruct(b, mask=m)
        finally:
            ref_eng.close()
        np.testing.assert_array_equal(got.recon, want.recon)


def test_engine_hot_swap_zero_compiles_and_parity(tmp_path):
    """The hot-swap core claim: a republished default bank serves new
    admissions from the new plan (one plan build, no kernel build: the
    stream records no compile) while pre-swap results match the old
    bank bit-for-bit."""
    dA, dB = _bank(0), _bank(1)
    geom = _geom(dA)
    eng = CodecEngine(
        dA, ReconstructionProblem(geom), _cfg(),
        _scfg(metrics_dir=str(tmp_path)),
    )
    try:
        t_ready = time.time()
        b, m = _req(5)
        pre = eng.reconstruct(b, mask=m)
        old, new = eng.publish_bank(None, dB)
        assert (old, new) == (bank_digest(dA), bank_digest(dB))
        post = eng.reconstruct(b, mask=m)
    finally:
        eng.close()
    events = obs.read_events(str(tmp_path))
    compiles = [
        e for e in events
        if e.get("type") == "compile" and e["t"] > t_ready
    ]
    assert compiles == [], "hot-swap must not build a kernel"
    swaps = [e for e in events if e.get("type") == "bank_swap"]
    assert len(swaps) == 1
    assert swaps[0]["old_digest"] == old
    assert swaps[0]["new_digest"] == new
    builds = [
        e for e in events if e.get("type") == "bank_plan_build"
    ]
    assert len(builds) == 1  # one bucket, one new-bank plan
    for d_ref, got in ((dA, pre), (dB, post)):
        ref = CodecEngine(
            d_ref, ReconstructionProblem(geom), _cfg(),
            _scfg(),
        )
        try:
            want = ref.reconstruct(b, mask=m)
        finally:
            ref.close()
        np.testing.assert_array_equal(got.recon, want.recon)


def test_engine_plan_evict_and_rebuild_on_miss(tmp_path, monkeypatch):
    """A plan evicted by the byte budget rebuilds on its next request
    (evict-and-rebuild): the request still serves, bit-identical."""
    # budget fits ~one plan: adding bank B evicts the idle default
    d = _bank(0)
    plan_bytes = registry_mod.plan_nbytes(_tiny_plan(0))
    monkeypatch.setenv(
        "CCSC_BANK_PLAN_CACHE_MB", str(plan_bytes * 1.5 / 1e6)
    )
    dB = _bank(1)
    geom = _geom(d)
    eng = CodecEngine(
        d, ReconstructionProblem(geom), _cfg(),
        _scfg(metrics_dir=str(tmp_path)),
    )
    try:
        eng.publish_bank("bank-b", dB)
        b, m = _req(5)
        got = eng.reconstruct(b, mask=m)  # default: rebuilt on miss
        st = eng.plan_cache_stats()
        assert st["evictions"] >= 1
        assert st["misses"] >= 1
    finally:
        eng.close()
    events = obs.read_events(str(tmp_path))
    assert any(
        e.get("type") == "bank_plan_evict" for e in events
    )
    ref = CodecEngine(
        d, ReconstructionProblem(geom), _cfg(), _scfg()
    )
    try:
        want = ref.reconstruct(b, mask=m)
    finally:
        ref.close()
    np.testing.assert_array_equal(got.recon, want.recon)


def test_engine_refuses_wrong_geometry_bank():
    d = _bank(0)
    eng = CodecEngine(
        d, ReconstructionProblem(_geom(d)), _cfg(),
        _scfg(),
    )
    try:
        with pytest.raises(CCSCInputError):
            eng.add_bank(_bank(1, k=6))  # wrong filter count
    finally:
        eng.close()


# ---------------------------------------------------------------------
# Fleet hot-swap proof (acceptance criterion)
# ---------------------------------------------------------------------


def test_fleet_hot_swap_mid_stream_zero_lost_bit_parity(tmp_path):
    """Continuous two-tenant traffic; tenant beta's bank republished
    under a new digest mid-stream. Zero lost requests; pre-swap beta
    results bit-identical to a fresh old-bank engine, post-swap to a
    fresh new-bank engine; the cutover is a bank_swap event carrying
    both digests; tenant alpha is untouched throughout."""
    dA, dB0, dB1 = _bank(0), _bank(1), _bank(2)
    geom = _geom(dA)
    tenants = (
        TenantSpec(tenant="alpha", bank_id="bank-a"),
        TenantSpec(tenant="beta", bank_id="bank-b"),
    )
    r = np.random.default_rng(11)
    reqs = []
    for _ in range(8):
        x = r.random((12, 12)).astype(np.float32)
        m = (r.random((12, 12)) < 0.5).astype(np.float32)
        reqs.append((x * m, m))
    tenant_of = lambda i: "alpha" if i % 2 == 0 else "beta"
    fleet = ServeFleet(
        dA, ReconstructionProblem(geom), _cfg(), _scfg(),
        FleetConfig(
            replicas=2, metrics_dir=str(tmp_path),
            min_queue_depth=64, verbose="none", tenants=tenants,
        ),
    )
    try:
        fleet.publish_bank("bank-a", dA)
        fleet.publish_bank("bank-b", dB0)
        pre = [
            fleet.submit(
                b, mask=m, tenant=tenant_of(i), key=f"pre{i}"
            )
            for i, (b, m) in enumerate(reqs)
        ]
        old, new = fleet.publish_bank("bank-b", dB1)
        assert (old, new) == (bank_digest(dB0), bank_digest(dB1))
        post = [
            fleet.submit(
                b, mask=m, tenant=tenant_of(i), key=f"post{i}"
            )
            for i, (b, m) in enumerate(reqs)
        ]
        pre_r = [f.result(timeout=120) for f in pre]
        post_r = [f.result(timeout=120) for f in post]
    finally:
        fleet.close()
    assert len(pre_r) == 8 and len(post_r) == 8  # zero lost
    events = obs.read_events(str(tmp_path), recursive=True)
    swaps = [
        e for e in events
        if e.get("type") == "bank_swap"
        and e.get("replica_id") is None
        and e.get("bank_id") == "bank-b"
        and e.get("old_digest") == old
    ]
    assert len(swaps) == 1 and swaps[0]["new_digest"] == new

    def oracle(d_ref, items):
        eng = CodecEngine(
            d_ref, ReconstructionProblem(geom), _cfg(),
            _scfg(),
        )
        try:
            return [eng.reconstruct(b, mask=m) for b, m in items]
        finally:
            eng.close()

    beta_items = [reqs[i] for i in range(8) if i % 2 == 1]
    for got, want in zip(
        [pre_r[i] for i in range(8) if i % 2 == 1],
        oracle(dB0, beta_items),
    ):
        np.testing.assert_array_equal(got.recon, want.recon)
    for got, want in zip(
        [post_r[i] for i in range(8) if i % 2 == 1],
        oracle(dB1, beta_items),
    ):
        np.testing.assert_array_equal(got.recon, want.recon)
    alpha_items = [reqs[i] for i in range(8) if i % 2 == 0]
    alpha_want = oracle(dA, alpha_items)
    for got, want in zip(
        [pre_r[i] for i in range(8) if i % 2 == 0]
        + [post_r[i] for i in range(8) if i % 2 == 0],
        alpha_want + alpha_want,
    ):
        np.testing.assert_array_equal(got.recon, want.recon)


def test_hot_swap_retires_superseded_digests(tmp_path):
    """Continuous republish must not accumulate every superseded
    bank forever: once nothing references an old digest (not routed,
    no queued/assigned request bound to it), a later publish's sweep
    drops its retained bytes and cached plans — while a digest with
    queued work is refused retirement and its requests still
    finish."""
    d0 = _bank(0)
    geom = _geom(d0)
    eng = CodecEngine(
        d0, ReconstructionProblem(geom), _cfg(),
        _scfg(),
    )
    try:
        b, m = _req(5)
        for seed in (1, 2, 3):
            eng.publish_bank(None, _bank(seed))
            eng.reconstruct(b, mask=m)  # drain so old goes idle
        # only the routed digest's bytes remain retained
        assert set(eng._banks) == {bank_digest(_bank(3))}
        assert eng._plan_cache.digests() == [bank_digest(_bank(3))]
        # a still-referenced digest (here: routed) refuses retirement
        assert not eng.retire_bank(eng.bank_digest(None))
    finally:
        eng.close()
    # fleet sweep: same contract across replicas
    fleet = ServeFleet(
        d0, ReconstructionProblem(geom), _cfg(), _scfg(),
        FleetConfig(
            replicas=1, metrics_dir=str(tmp_path),
            min_queue_depth=64, verbose="none",
        ),
    )
    try:
        for seed in (1, 2, 3):
            fleet.publish_bank("bank-x", _bank(seed))
            b, m = _req(5)
            fleet.submit(b, mask=m, bank_id="bank-x").result(
                timeout=120
            )
        fleet.publish_bank("bank-x", _bank(4))
        assert set(fleet._bank_arrays) == {
            bank_digest(d0), bank_digest(_bank(4))
        }
    finally:
        fleet.close()


def test_fleet_restart_republishes_banks(tmp_path):
    """A replica killed AFTER extra banks were published must come
    back able to serve them: the restart republishes every retained
    bank before the replacement takes work."""
    from ccsc_code_iccv2017_torch.utils import faults

    dA, dB = _bank(0), _bank(1)
    geom = _geom(dA)
    old_env = {
        k: os.environ.get(k)
        for k in (
            "CCSC_FAULT_ENGINE_KILL_REQ",
            "CCSC_FAULT_ENGINE_KILL_REPLICA",
        )
    }
    os.environ["CCSC_FAULT_ENGINE_KILL_REQ"] = "2"
    os.environ["CCSC_FAULT_ENGINE_KILL_REPLICA"] = "0"
    faults.reset()
    try:
        fleet = ServeFleet(
            dA, ReconstructionProblem(geom), _cfg(), _scfg(),
            FleetConfig(
                replicas=1, metrics_dir=str(tmp_path),
                min_queue_depth=64, restart_backoff_s=0.05,
                verbose="none",
            ),
        )
        try:
            fleet.publish_bank("bank-b", dB)
            futs = []
            for i in range(6):
                b, m = _req(20 + i)
                futs.append(
                    fleet.submit(
                        b, mask=m, bank_id="bank-b", key=f"k{i}"
                    )
                )
            results = [f.result(timeout=180) for f in futs]
            assert len(results) == 6
        finally:
            fleet.close()
        events = obs.read_events(str(tmp_path), recursive=True)
        assert any(
            e.get("type") == "fleet_replica_dead" for e in events
        )
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()


# ---------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_a_registry_the_other_wrote(tmp_path, writer):
    """The on-disk format is the JAX package's: the same bank bytes
    land in the same content-addressed file, the manifest records carry
    the same fields and values (the publish time aside), and each
    package resolves, loads and continues the sequence of a registry
    the other wrote."""
    d0, d1 = _bank(0), _bank(1)
    w_cls, r_cls = ((BankRegistry, jregistry.BankRegistry)
                    if writer == "port" else
                    (jregistry.BankRegistry, BankRegistry))
    wdir, odir = str(tmp_path / "w"), str(tmp_path / "o")
    w = w_cls(wdir)
    w.publish("bank-a", d0, tenant="alpha", note="first")
    w.publish("bank-a", d1)
    w.close()
    # the other package writing the same publishes: same files, same
    # records
    o = r_cls(odir)
    o.publish("bank-a", d0, tenant="alpha", note="first")
    o.publish("bank-a", d1)
    o.close()
    for dg in (bank_digest(d0), bank_digest(d1)):
        rel = os.path.join("banks", f"{dg}.npy")
        with open(os.path.join(wdir, rel), "rb") as f1, \
                open(os.path.join(odir, rel), "rb") as f2:
            assert f1.read() == f2.read()
    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t"} for r in recs]

    r = r_cls(wdir)
    try:
        assert strip(r.history("bank-a")) == strip(
            r_cls(odir).history("bank-a"))
        arr, man = r.load("bank-a")
        np.testing.assert_array_equal(arr, d1)
        assert man["digest"] == bank_digest(d1)
        assert r.previous("bank-a")["digest"] == bank_digest(d0)
        assert r.publish("bank-b", d0)["seq"] == 3  # continues
    finally:
        r.close()
    assert registry_mod.render_manifest(man) == jregistry.render_manifest(
        man)
    assert registry_mod.manifest_json(man) == jregistry.manifest_json(man)


def test_fleet_hot_swap_matches_the_jax_fleet(tmp_path):
    """The same mid-stream republish through both fleets: every
    pre-swap and post-swap result of the port within REC_TOL of the
    JAX fleet's, and both streams carry one fleet-scope bank_swap with
    the same two digests."""
    jrec = importlib.import_module(
        "ccsc_code_iccv2017_tpu.models.reconstruct")
    dA, dB0, dB1 = _bank(0), _bank(1), _bank(2)
    reqs = [_req(40 + i) for i in range(4)]
    cfg_kw = dict(lambda_residual=5.0, lambda_prior=0.3, max_it=3,
                  tol=0.0, verbose="none", track_objective=True)

    def drive(fleet):
        fleet.publish_bank("bank-b", dB0)
        pre = [fleet.submit(b, mask=m, bank_id="bank-b", key=f"pre{i}")
               for i, (b, m) in enumerate(reqs)]
        swap = fleet.publish_bank("bank-b", dB1)
        post = [fleet.submit(b, mask=m, bank_id="bank-b", key=f"post{i}")
                for i, (b, m) in enumerate(reqs)]
        return swap, [f.result(timeout=120) for f in pre + post]

    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jgeom = jcfg.ProblemGeom((3, 3), 4)
    jf = jserve.ServeFleet(
        jnp.asarray(dA), jrec.ReconstructionProblem(jgeom),
        jcfg.SolveConfig(**cfg_kw),
        jcfg.ServeConfig(buckets=((2, (12, 12)),), max_wait_ms=2.0,
                         verbose="none"),
        jcfg.FleetConfig(replicas=2, metrics_dir=jdir,
                         min_queue_depth=64, verbose="none"),
    )
    try:
        jswap, jres = drive(jf)
    finally:
        jf.close()
    tf = ServeFleet(
        dA, ReconstructionProblem(_geom(dA)), SolveConfig(**cfg_kw),
        _scfg(), FleetConfig(replicas=2, metrics_dir=tdir,
                             min_queue_depth=64, verbose="none"),
    )
    try:
        tswap, tres = drive(tf)
    finally:
        tf.close()
    assert tswap == jswap == (bank_digest(dB0), bank_digest(dB1))
    assert len(tres) == len(jres) == 8  # zero lost
    for a, b in zip(tres, jres):
        assert _rel(a.recon, b.recon) <= REC_TOL
    from ccsc_code_iccv2017_tpu.utils import obs as jobs

    for evs in (obs.read_events(tdir), jobs.read_events(jdir)):
        swaps = [(e["old_digest"], e["new_digest"]) for e in evs
                 if e["type"] == "bank_swap" and e["bank_id"] == "bank-b"
                 and e["old_digest"] is not None]
        assert swaps == [tswap]
