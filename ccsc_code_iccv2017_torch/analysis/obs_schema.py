"""The declared obs event schema: every event type the framework may
emit, with the fields consumers rely on (a copy of
``ccsc_code_iccv2017_tpu.analysis.obs_schema``, whole: the port's stream
keeps this contract, including record types it does not emit yet).

``utils.obs`` writes whatever fields an emit site passes; the
dashboard (``scripts/obs_report.py``), the watchdog's replica/peer
liveness (``utils.watchdog``), the supervisor's preemption judgment
(``scripts/supervise.py``), and the serve bench all read those fields
back by name. Nothing used to tie the two ends together — a renamed
field or a typo'd event type silently emptied a dashboard section.
This registry is the contract; the ``obs-schema`` check validates
every emit site (literal event name + required fields present) and
every consumer-side event-name literal against it.

Stdlib-only on purpose: the linter imports this module directly.
"""
from __future__ import annotations

from typing import Dict, FrozenSet

__all__ = ["EVENT_SCHEMA", "required_fields"]


def _s(*names: str) -> FrozenSet[str]:
    return frozenset(names)


# event type -> fields REQUIRED at every emit site (consumers may read
# more — optional fields are free — but these must always be present)
EVENT_SCHEMA: Dict[str, FrozenSet[str]] = {
    # -- core run telemetry (utils.obs) ------------------------------
    "run_meta": _s("algorithm"),
    "step": _s("it"),
    "roofline": _s("start_it", "length", "n_adopted", "dt_s",
                   "it_per_sec"),
    "heartbeat": _s("step", "fence_latency_s"),
    "phase": _s("phase", "sections"),
    "log": _s("tier", "msg"),
    "compile": _s("kind", "duration_s"),
    "summary": _s("status"),
    # -- resilience / supervision ------------------------------------
    "checkpoint_save": _s("path", "iteration"),
    "checkpoint_load": _s("path", "iteration"),
    "recovery": _s(),
    "preemption": _s("iteration", "signum"),
    "stall": _s("label", "action"),
    "peer_stale": _s("host"),
    "fault_fired": _s("fault"),
    "degrade": _s("rung", "stage"),
    # -- request-level tracing (utils.trace; span conventions are
    # themselves lint-enforced: every span_* event requires
    # trace_id/span/span_id/replica_id, and a span_end emitted for a
    # literal span name needs a matching span_start emitter) --------
    "span_start": _s("trace_id", "span", "span_id", "replica_id"),
    "span_end": _s("trace_id", "span", "span_id", "replica_id",
                   "status"),
    # -- SLO layer (serve.slo) ---------------------------------------
    "slo_breach": _s("replica_id", "phase", "quantile", "target_ms",
                     "observed_ms"),
    "slo_histogram": _s("replica_id", "phase", "counts", "n"),
    "slo_profile": _s("replica_id", "trace_dir"),
    # -- serving engine (serve.engine; replica_id stamped by _emit).
    # ``devices``/``mesh`` are the replica's device topology (mesh
    # engines: ServeConfig.mesh_shape) — obs_report's SERVING section
    # and the mixed-fleet ceiling check read them back ----------------
    "serve_warmup": _s("replica_id", "bucket", "warmup_s", "knobs",
                       "devices", "source"),
    "serve_ready": _s("replica_id", "n_buckets", "warmup_s",
                      "devices"),
    # -- compiled-artifact store + staged warmup (serve.artifacts,
    # serve.engine). artifact_fetch/publish announce store traffic
    # with a per-call status (hit/miss/chip_mismatch/... resp.
    # won/lost/exists/repair); warmup_stage is the per-bucket staged
    # timeline (ready_s since warmup start, source = fetched |
    # compiled | cache-hit | lazy); bucket_cold is the staged
    # admission refusal (engine- or fleet-scope, so no forced
    # replica_id — the engine's _emit stamps one anyway) -------------
    "artifact_fetch": _s("key", "status"),
    "artifact_publish": _s("key", "status"),
    # comm_audit is the per-bucket collective-budget verdict
    # (analysis.comms counts collective op definitions in the AOT
    # program's stable HLO; budget = declared per-solve allowance,
    # total = measured static count, ok = within budget). Emitted at
    # warmup for every mesh bucket program; scripts/comm_audit.py and
    # the ci.sh collective-audit leg re-derive the same verdict ------
    "comm_audit": _s("bucket", "mesh", "budget", "total", "ok"),
    "warmup_stage": _s("bucket", "stage", "source", "ready_s"),
    "bucket_cold": _s("bucket", "retry_after_s"),
    "serve_request": _s("replica_id", "trace_id", "bucket",
                        "latency_ms", "iters"),
    "serve_dispatch": _s("replica_id", "bucket", "n", "slots",
                         "occupancy", "queue_depth", "dt_s"),
    "serve_error": _s("replica_id", "error"),
    "serve_drain": _s("replica_id", "n"),
    # -- serving fleet (serve.fleet) ---------------------------------
    "fleet_start": _s("replica_id", "replicas", "queue_ceiling"),
    "fleet_heartbeat": _s("replica_id", "state", "served",
                          "restarts"),
    "fleet_request": _s("replica_id", "trace_id", "key",
                        "latency_ms"),
    "fleet_requeue": _s("replica_id", "reason", "n"),
    "fleet_duplicate_suppressed": _s("replica_id", "trace_id",
                                     "key"),
    "fleet_metricsd": _s("replica_id", "port"),
    # -- request lifecycle (serve.fleet, serve.engine,
    # serve.dqueue, serve.federation). deadline_exceeded is the
    # expired-request refusal at whichever boundary the request died
    # at (where = admission | engine | queue | claim | dispatch; the
    # stamped absolute deadline rides along); request_cancelled the
    # cooperative pre-dispatch withdrawal of a client-cancelled
    # future; hedge_spawn/_win/_lost the hedged-attempt lifecycle
    # (the loser is suppressed by the existing at-most-once fencing,
    # never double-delivered); fleet_gray_replica the advisory
    # slow-but-alive signal (sustained latency outlier vs the fleet
    # median — distinct from the watchdog's stall detector) ----------
    "deadline_exceeded": _s("where", "deadline"),
    "request_cancelled": _s("where", "key"),
    "hedge_spawn": _s("replica_id", "trace_id", "key",
                      "waited_ms", "hedge_after_ms"),
    "hedge_win": _s("replica_id", "trace_id", "key"),
    "hedge_lost": _s("replica_id", "trace_id", "key"),
    "fleet_gray_replica": _s("replica_id", "p50_ms",
                             "fleet_p50_ms", "factor"),
    "fleet_replica_dead": _s("replica_id", "reason"),
    "fleet_replica_restart": _s("replica_id", "attempt"),
    "fleet_replica_ready": _s("replica_id", "generation"),
    "fleet_replica_abandoned": _s("replica_id", "restarts"),
    "fleet_admission_reject": _s("replica_id", "queue_depth",
                                 "ceiling", "rung", "retry_after_s"),
    "fleet_ceiling": _s("replica_id", "ceiling", "source"),
    "fleet_overload": _s("replica_id", "rung_from", "rung_to",
                         "queue_depth"),
    # -- live elasticity (serve.fleet.set_replica_count): fleet_scale
    # announces a target change (grow or shrink); fleet_replica_retired
    # marks a slot drained-then-retired (scale-down), as opposed to
    # dead/abandoned ------------------------------------------------
    "fleet_scale": _s("replica_id", "from_n", "to_n", "reason"),
    "fleet_replica_retired": _s("replica_id", "reason"),
    # -- capacity controller (serve.controller). Every decision event
    # carries the sensor ``snapshot`` dict that justified it so
    # obs_report can replay why capacity moved. ctrl_decision is the
    # intent, ctrl_scale/ctrl_brownout the actuation outcomes,
    # ctrl_holdoff a wanted-but-suppressed action (stale sensors,
    # cooldown, breaker open, bounds, HBM veto) ----------------------
    "ctrl_decision": _s("replica_id", "action", "reason", "snapshot"),
    "ctrl_scale": _s("replica_id", "direction", "from_n", "to_n",
                     "ok"),
    "ctrl_brownout": _s("replica_id", "on", "reason"),
    "ctrl_holdoff": _s("replica_id", "reason"),
    # -- multi-tenant bank registry + tenancy (serve.registry,
    # serve.tenancy, serve.engine, serve.fleet). bank_publish is the
    # registry's durable-publication announcement; bank_swap is the
    # zero-downtime cutover (old->new digest, replica_id None for the
    # fleet-wide flip); bank_plan_build/evict are the per-bank plan
    # LRU's accounting; tenant_reject is a per-tenant quota refusal
    # (the bursting tenant's own Overloaded while other tenants'
    # admissions hold) ------------------------------------------------
    "bank_publish": _s("bank_id", "digest"),
    "bank_swap": _s("replica_id", "bank_id", "old_digest",
                    "new_digest"),
    "bank_plan_build": _s("replica_id", "digest", "bucket",
                          "build_s"),
    "bank_plan_evict": _s("replica_id", "digest", "bucket"),
    "tenant_reject": _s("replica_id", "tenant", "queue_depth",
                        "quota"),
    # -- quality observatory (serve.quality; emitted through the
    # engine/fleet emit wrappers). quality_breach is a tenant's
    # declared dB floor violated (TenantSpec.min_psnr_db, the
    # slo_breach discipline); quality_histogram is the periodic
    # per-(bank, tenant, bucket) dB snapshot; quality_solve_diag the
    # per-bucket on-device solve diagnostics (objective split,
    # stop-reason fractions, nonfinite count); quality_probe /
    # quality_probe_breach the golden-probe verdicts;
    # quality_drift a bank's rolling served dB below its ledger
    # band; quality_demote_advice the advisory demotion signal a
    # registry/controller (or operator) consumes -------------------
    "quality_breach": _s("replica_id", "tenant", "min_psnr_db",
                         "observed_db", "n"),
    "quality_histogram": _s("replica_id", "bank_id", "tenant",
                            "bucket", "counts", "n"),
    "quality_solve_diag": _s("replica_id", "bucket", "n",
                             "iters_mean", "tol_stop_frac",
                             "nonfinite"),
    "quality_probe": _s("replica_id", "probe", "bank_id", "digest",
                        "status", "db"),
    "quality_probe_breach": _s("replica_id", "probe", "bank_id",
                               "digest", "db", "ref_db"),
    "quality_drift": _s("replica_id", "bank_id", "digest",
                        "rolling_db", "band_lo", "n_history"),
    "quality_demote_advice": _s("replica_id", "bank_id",
                                "from_digest", "to_digest",
                                "reason"),
    # -- workload capture + replay (serve.capture, serve.replay).
    # capture_* events are session-scope (emitted by the recorder
    # through the fleet/engine emit wrapper); replay_* events live in
    # the replay driver's own stream and feed obs_report's REPLAY
    # section -------------------------------------------------------
    "capture_start": _s("path"),
    "capture_rotate": _s("path", "segment"),
    "capture_error": _s("path", "error"),
    "capture_summary": _s("path", "n_requests", "overhead_s"),
    "replay_request": _s("key", "status", "latency_ms"),
    "replay_summary": _s("mode", "speed", "n_recorded", "n_replayed",
                         "n_lost", "n_mismatched"),
    # -- cross-host federation (serve.dqueue, serve.federation).
    # dqueue_* are queue-protocol events (submit/claim/complete/
    # requeue/fail/suppress — the ``host`` field is the federated
    # host id, not the process index); fed_* are host-pool lifecycle
    # events the FEDERATION report section and per-host liveness
    # read --------------------------------------------------------
    "dqueue_submit": _s("key"),
    "dqueue_claim": _s("key", "host", "attempt"),
    "dqueue_complete": _s("key", "host", "digest"),
    "dqueue_requeue": _s("key", "from_host", "reason"),
    "dqueue_failed": _s("key", "attempts"),
    "dqueue_suppressed": _s("key", "host", "reason"),
    "fed_join": _s("host", "epoch"),
    "fed_leave": _s("host", "served"),
    "fed_heartbeat": _s("host", "epoch", "served"),
    # -- autotuning (tune.autotune) ----------------------------------
    "tune_pick": _s("kind", "chip", "shape_key"),
    "tune_guard": _s("kind", "chip"),
    "tune_arm": _s("kind", "chip", "shape_key"),
    # -- performance observatory (analysis.ledger, utils.memwatch) ---
    # perf_anomaly: the live anomaly watch — a run's rolling roofline
    # fraction fell below its historical band (analysis.ledger
    # AnomalyWatch, emitted from Run.chunk)
    "perf_anomaly": _s("rolling_frac", "band_lo", "n_history"),
    # mem_watermark: measured peak HBM vs the perfmodel estimate
    # (utils.memwatch sampled at dispatch fences; emitted at close)
    "mem_watermark": _s("peak_hbm_bytes", "n_samples"),
    # mem_oom_dump: RESOURCE_EXHAUSTED forensic dump written
    "mem_oom_dump": _s("path"),
    # ledger_append: a normalized perf record entered the durable
    # run ledger (CCSC_PERF_LEDGER)
    "ledger_append": _s("key", "value", "unit"),
}


def required_fields(event: str) -> FrozenSet[str]:
    return EVENT_SCHEMA.get(event, frozenset())
