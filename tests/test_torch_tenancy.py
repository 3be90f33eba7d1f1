"""The port's tenancy layer (``ccsc_code_iccv2017_torch.serve.tenancy``,
``TenantSpec``, ``serve.slo.TenantSlos``) against the JAX package on the
same inputs, and the port fleet's per-tenant admission on the CPU at
tests/test_tenancy.py's tiny problem (k=4 3x3 bank, 12x12 requests,
max_it 3).

Contracts under test:
- ``TenantSpec`` validation and the CLI grammar ``parse_tenant_spec``
  give JAX's specs and JAX's refusals;
- ``TenantTable`` routes and quotas, and ``WeightedFairScheduler``
  pops in JAX's order (weighted shares, FIFO within a tenant,
  requeue-to-front, idle tenants bank no credit, untenanted FIFO);
- the isolation proof: a bursting tenant past its quota gets explicit
  ``Overloaded`` refusals (``tenant_reject``) while the other tenant
  serves every request within its own declared p99;
- the capture records each request's tenant and bank id, read back by
  the JAX package's capture reader.
"""
import dataclasses
import types

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu.serve import slo as jslo
from ccsc_code_iccv2017_tpu.serve import tenancy as jten
from ccsc_code_iccv2017_torch.config import (
    FleetConfig,
    ProblemGeom,
    ServeConfig,
    SolveConfig,
    TenantSpec,
)
from ccsc_code_iccv2017_torch.models.reconstruct import (
    ReconstructionProblem,
)
from ccsc_code_iccv2017_torch.serve import (
    Overloaded,
    ServeFleet,
    TenantSlos,
    WeightedFairScheduler,
    parse_tenant_spec,
)
from ccsc_code_iccv2017_torch.serve.metricsd import render_prometheus
from ccsc_code_iccv2017_torch.serve.tenancy import TenantTable
from ccsc_code_iccv2017_torch.utils import obs
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError


def _bank(seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(4, 3, 3)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfg(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_objective=True,
    )
    base.update(kw)
    return SolveConfig(**base)


def _req(seed=1):
    r = np.random.default_rng(seed)
    x = r.random((12, 12)).astype(np.float32)
    m = (r.random((12, 12)) < 0.5).astype(np.float32)
    return x * m, m


def _fleet(d, tenants, buckets=((2, (12, 12)),), **kw):
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    return ServeFleet(
        d, ReconstructionProblem(geom), _cfg(),
        ServeConfig(buckets=buckets, max_wait_ms=kw.pop("max_wait_ms", 2.0),
                    verbose="none"),
        FleetConfig(replicas=1, min_queue_depth=64, verbose="none",
                    tenants=tenants, **kw),
        device="cpu",
    )


def _same_outcome(port_fn, jax_fn):
    """Both calls return equal values, or both raise an error of the
    same class name with the same message."""
    try:
        want = jax_fn()
    except Exception as e:  # the JAX package's refusal
        with pytest.raises(Exception) as got:
            port_fn()
        # the same class (each package has its own CCSCInputError)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return None
    got = port_fn()
    return got, want


# ---------------------------------------------------------------------
# specs, grammar, table
# ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(tenant=""), dict(tenant="t", weight=0.0), dict(tenant="t", quota=0),
    dict(tenant="t", slo_p99_ms=-1.0), dict(tenant="t", min_psnr_db=0.0),
    dict(tenant="t", deadline_ms=-5.0),
    dict(tenant="t", bank_id="b", slo_p50_ms=5.0, quota=3, weight=2.5,
         min_psnr_db=20.0, deadline_ms=100.0),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_tenant_spec_validation_matches_jax(kw):
    out = _same_outcome(lambda: TenantSpec(**kw),
                        lambda: jcfg.TenantSpec(**kw))
    if out is not None:
        assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])


@pytest.mark.parametrize("spec", [
    "mobile:bank=bank-m,p50=50,p99=250,quota=16,weight=2",
    "web", "web:", "a:min_db=31.5,deadline=250", "b: quota = 3 ",
    "web:bogus=1", "web:quota=many", "web:weight=0", ":quota=1",
    "x:bank=", "x:p99",
])
def test_parse_tenant_spec_matches_jax(spec):
    out = _same_outcome(lambda: parse_tenant_spec(spec),
                        lambda: jten.parse_tenant_spec(spec))
    if out is not None:
        assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])


def test_duplicate_tenants_refused_like_jax():
    out = _same_outcome(
        lambda: FleetConfig(tenants=(TenantSpec("a"), TenantSpec("a"))),
        lambda: jcfg.FleetConfig(tenants=(jcfg.TenantSpec("a"),
                                          jcfg.TenantSpec("a"))))
    assert out is None  # both refused, same message


def _specs(pkg_spec, rows):
    return tuple(pkg_spec(**r) for r in rows)


TABLE_ROWS = [
    dict(tenant="a", bank_id="bank-a", weight=3.0),
    dict(tenant="b", quota=7, weight=1.0),
    dict(tenant="c", weight=0.25),
]


@pytest.mark.parametrize("ceiling", [1, 8, 100, 1000])
def test_tenant_table_routing_and_quota_match_jax(ceiling, monkeypatch):
    monkeypatch.delenv("CCSC_TENANT_QUOTA_FRAC", raising=False)
    pt = TenantTable(_specs(TenantSpec, TABLE_ROWS))
    jt = jten.TenantTable(_specs(jcfg.TenantSpec, TABLE_ROWS))
    for tenant in ("a", "b", "c", None):
        for bank in (None, "explicit"):
            assert pt.route(tenant, bank) == jt.route(tenant, bank)
        assert pt.quota(tenant, ceiling) == jt.quota(tenant, ceiling)
    assert pt.names() == jt.names()
    for typo in ("typo", None):
        _same_outcome(lambda: pt.check(typo), lambda: jt.check(typo))
    assert pt.route("a", None) == "bank-a"
    with pytest.raises(CCSCInputError, match="unknown tenant"):
        pt.check("typo")


# ---------------------------------------------------------------------
# weighted-fair scheduler: JAX's pop order on the same sequence
# ---------------------------------------------------------------------


def _drive(sched, ops):
    """Run ``ops`` (("push", tenant, n) | ("front", tenant, n) |
    ("pop",)) and return the popped (tenant, n) sequence."""
    out = []
    for op in ops:
        if op[0] == "push":
            sched.append(types.SimpleNamespace(tenant=op[1], n=op[2]))
        elif op[0] == "front":
            sched.appendleft(types.SimpleNamespace(tenant=op[1], n=op[2]))
        else:
            it = sched.popleft()
            out.append((it.tenant, it.n))
    out.append(("left", len(sched)))
    return out


def _ops_shares():
    ops = [("push", "heavy", i) for i in range(12)]
    ops += [("push", "light", i) for i in range(4)]
    return ops + [("pop",)] * 16


def _ops_idle():
    ops = [("push", "busy", i) for i in range(50)] + [("pop",)] * 50
    for i in range(4):
        ops += [("push", "idle", i), ("push", "busy", 100 + i)]
    return ops + [("pop",)] * 8


def _ops_requeue():
    return [("push", "heavy", 0), ("push", "heavy", 1), ("push", "light", 0),
            ("pop",), ("front", "heavy", 0), ("pop",), ("pop",), ("pop",)]


def _ops_random(seed=5):
    r = np.random.default_rng(seed)
    ops, n = [], 0
    for _ in range(300):
        u = r.random()
        if u < 0.55:
            ops.append(("push", ["heavy", "light", "busy", None][
                int(r.integers(4))], n))
            n += 1
        else:
            ops.append(("pop",))
    return ops


SCHED_SPECS = [dict(tenant="heavy", weight=3.0), dict(tenant="light"),
               dict(tenant="busy", weight=0.5), dict(tenant="idle")]


@pytest.mark.parametrize("name,ops", [
    ("shares", _ops_shares()), ("idle", _ops_idle()),
    ("requeue", _ops_requeue()), ("random", _ops_random()),
])
def test_weighted_fair_order_matches_jax(name, ops):
    def run(sched):
        try:
            return _drive(sched, ops)
        except IndexError as e:  # pop of an empty queue
            return ("IndexError", str(e))

    got = run(WeightedFairScheduler(
        TenantTable(_specs(TenantSpec, SCHED_SPECS))))
    want = run(jten.WeightedFairScheduler(
        jten.TenantTable(_specs(jcfg.TenantSpec, SCHED_SPECS))))
    assert got == want
    if name == "shares":
        first8 = [t for t, _ in got[:8]]
        assert first8.count("heavy") == 6 and first8.count("light") == 2


def test_scheduler_untenanted_is_fifo_like_jax():
    ops = [("push", None, i) for i in range(5)] + [("pop",)] * 5
    got = _drive(WeightedFairScheduler(TenantTable(None)), ops)
    assert got == _drive(jten.WeightedFairScheduler(jten.TenantTable(None)),
                         ops)
    assert [n for _, n in got[:5]] == list(range(5))
    with pytest.raises(IndexError):
        WeightedFairScheduler(TenantTable(None)).popleft()


def test_tenant_slos_match_jax():
    rows = [dict(tenant="a", slo_p99_ms=10.0),
            dict(tenant="b", slo_p99_ms=1e6, slo_p50_ms=1.0)]
    ps = TenantSlos(_specs(TenantSpec, rows), check_s=0.0)
    js = jslo.TenantSlos(_specs(jcfg.TenantSpec, rows), check_s=0.0)
    r = np.random.default_rng(3)
    for v in r.lognormal(4.0, 1.5, size=200):
        for t in ("a", "b", None):
            ps.observe(t, float(v))
            js.observe(t, float(v))
    pb, psn = ps.final()
    jb, jsn = js.final()
    assert pb == jb and psn == jsn
    assert [b["tenant"] for b in pb] and {b["tenant"] for b in pb} <= {
        "a", "b"}
    for t in ("a", "b"):
        assert ps.percentile(t, 0.99) == js.percentile(t, 0.99)


# ---------------------------------------------------------------------
# the fleet's per-tenant admission
# ---------------------------------------------------------------------


def test_quota_isolation_burst_rejected_other_tenant_holds(tmp_path):
    """Tenant 'burst' floods past its quota: it gets explicit
    Overloaded refusals (tenant_reject events, counted per tenant)
    while tenant 'steady' serves every request and its p99 — from
    its own histogram — stays within its declared target."""
    d = _bank(0)
    steady_p99_ms = 60_000.0  # a generous CPU band: the claim is
    # judged from steady's OWN histogram
    tenants = (
        TenantSpec(tenant="burst", quota=2, weight=1.0),
        TenantSpec(tenant="steady", slo_p99_ms=steady_p99_ms, weight=1.0,
                   quota=64),
    )
    fleet = _fleet(d, tenants, buckets=((1, (12, 12)),), max_wait_ms=1.0,
                   metrics_dir=str(tmp_path))
    n_rejected = 0
    steady_futs, burst_futs = [], []
    try:
        for i in range(30):
            b, m = _req(i)
            try:
                burst_futs.append(fleet.submit(
                    b, mask=m, tenant="burst", key=f"burst{i}"))
            except Overloaded as e:
                n_rejected += 1
                assert e.retry_after_s > 0
            bs, ms = _req(100 + i)
            steady_futs.append(fleet.submit(
                bs, mask=ms, tenant="steady", key=f"steady{i}"))
        steady_r = [f.result(timeout=300) for f in steady_futs]
        burst_r = [f.result(timeout=300) for f in burst_futs]
        st = fleet.stats()
    finally:
        fleet.close()
    assert n_rejected >= 1, "the burst must hit its quota"
    assert len(steady_r) == 30
    assert len(burst_r) == len(burst_futs)
    assert st["tenants"]["burst"]["rejected"] == n_rejected
    assert st["tenants"]["steady"]["rejected"] == 0
    assert st["tenants"]["steady"]["delivered"] == 30
    p99_s = st["tenants"]["steady"]["p99_latency_s"]
    assert p99_s is not None and p99_s * 1e3 <= steady_p99_ms
    events = obs.read_events(str(tmp_path), recursive=True)
    rejects = [e for e in events if e.get("type") == "tenant_reject"]
    assert len(rejects) == n_rejected
    assert all(e["tenant"] == "burst" and e["quota"] == 2 for e in rejects)
    assert not any(e.get("type") == "slo_breach"
                   and e.get("tenant") == "steady" for e in events)
    t_hists = [e for e in events if e.get("type") == "slo_histogram"
               and e.get("tenant") == "steady"]
    assert t_hists and t_hists[-1]["target_p99_ms"] == steady_p99_ms


def test_unknown_tenant_refused():
    fleet = _fleet(_bank(0), (TenantSpec(tenant="a"),))
    try:
        b, m = _req(1)
        with pytest.raises(CCSCInputError, match="unknown tenant"):
            fleet.submit(b, mask=m, tenant="typo")
        fleet.submit(b, mask=m).result(timeout=120)  # None: fine
    finally:
        fleet.close()


def test_fleet_metrics_carry_tenant_series():
    fleet = _fleet(_bank(0), (TenantSpec(tenant="a", slo_p99_ms=60_000.0),))
    try:
        b, m = _req(1)
        fleet.submit(b, mask=m, tenant="a", key="k0").result(timeout=120)
        metrics = fleet.metrics()
        text = render_prometheus(metrics)
    finally:
        fleet.close()
    assert ("tenant_requests_total", {"tenant": "a"}, 1) in (
        metrics["labeled_counters"])
    assert 'ccsc_tenant_requests_total{tenant="a"} 1' in text
    assert 'tenant="a"' in text and "ccsc_latency_ms_bucket" in text


def test_mixed_tenant_capture_records_routes_for_the_jax_reader(tmp_path):
    """Each admitted request's tenant and bank id land in the fleet's
    capture, and the JAX package's capture reader reads them back."""
    from ccsc_code_iccv2017_tpu.serve import capture as jcap

    dA, dB = _bank(0), _bank(1)
    tenants = (TenantSpec(tenant="alpha", bank_id="bank-a"),
               TenantSpec(tenant="beta", bank_id="bank-b"))
    cap_dir = str(tmp_path / "capture")
    fleet = _fleet(dA, tenants, capture_dir=cap_dir)
    try:
        fleet.publish_bank("bank-a", dA)
        fleet.publish_bank("bank-b", dB)
        futs = [fleet.submit(*_req(i)[:1], mask=_req(i)[1],
                             tenant="alpha" if i % 2 == 0 else "beta",
                             key=f"k{i}") for i in range(6)]
        [f.result(timeout=120) for f in futs]
    finally:
        fleet.close()
    recs = jcap.read_workload(cap_dir)
    assert len(recs) == 6
    by_key = {r["key"]: r for r in recs}
    for i in range(6):
        r = by_key[f"k{i}"]
        assert r["tenant"] == ("alpha" if i % 2 == 0 else "beta")
        assert r["bank_id"] == ("bank-a" if i % 2 == 0 else "bank-b")
