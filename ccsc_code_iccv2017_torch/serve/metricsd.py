"""Live metrics surface: a stdlib-only Prometheus-text HTTP endpoint
plus an atomic snapshot file, fed by a running fleet or engine.

The obs streams are the system of record, but they answer "what
happened" after a reader parses JSONL; a serving fleet also needs
"what is true RIGHT NOW" answerable by anything that can speak HTTP —
a Prometheus scraper, ``curl`` in an incident, a k8s liveness probe.
This module is that surface, with zero dependencies beyond the
standard library:

- :class:`MetricsD` serves ``GET /metrics`` in Prometheus text
  exposition format (counters, gauges, and the ``serve.slo``
  latency histograms as cumulative ``_bucket{le=...}`` series) from
  a ``source`` — any callable returning the metrics dict shape of
  ``ServeFleet.metrics()`` / ``CodecEngine.metrics()``, or a metrics
  DIR, in which case a :class:`StreamMetrics` tails the event stream
  incrementally (``utils.obs.EventTail`` — each scrape costs O(new
  records), never a full re-read) so the endpoint can run beside a
  process it does not share memory with.
- The same text is written ATOMICALLY (tmp + rename) to a snapshot
  file every ``CCSC_METRICSD_INTERVAL_S`` seconds for scrape-less
  environments: a sidecar, ``cat``, or a log shipper reads a
  complete, never-torn exposition.
- Every exposition carries a FRESHNESS STAMP:
  ``ccsc_snapshot_timestamp_seconds`` (write time — a reader
  comparing it to the wall clock detects a snapshot whose fleet died
  with it), ``ccsc_snapshot_age_seconds`` (seconds since the
  underlying metrics last CHANGED — a live sidecar over a dead
  source shows it growing), and ``ccsc_snapshot_info{run_id=...}``
  (the fleet run identity, so a stale file names the fleet that
  abandoned it). ``parse_snapshot_stamp`` reads it back;
  ``scripts/obs_report.py`` flags staleness past ``--stale-after``.

Wiring: ``FleetConfig.metricsd_port`` (or ``CCSC_METRICSD_PORT``;
0 = an ephemeral port, reported in the ``fleet_metricsd`` event and
``MetricsD.port``) starts one inside :class:`~.fleet.ServeFleet`;
``apps/serve.py --metricsd-port`` wires a standalone engine. The
server binds 127.0.0.1 — exposure beyond the host is a deployment
decision, not a default.
"""
from __future__ import annotations

import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..utils import env as _env

__all__ = [
    "MetricsD",
    "StreamMetrics",
    "parse_snapshot_stamp",
    "render_prometheus",
    "resolve_endpoint",
    "tenant_labeled_counters",
]

_PREFIX = "ccsc"
# exposition format version, stamped into every snapshot/scrape:
# 2 = per-tenant labeled counter series (serve.tenancy) added
# 3 = quality plane series (serve.quality): ccsc_psnr_db histograms,
#     ccsc_probe_failures_total, ccsc_quality_breach. Purely
#     additive — parse_snapshot_stamp and every format-2 series are
#     byte-identical, so format-2 readers keep parsing format-3 files
SNAPSHOT_FORMAT = 3


def resolve_endpoint(
    port: Optional[int],
    snapshot: Optional[str],
    metrics_dir: Optional[str],
) -> Tuple[Optional[int], Optional[str]]:
    """The ONE resolution chain for the metrics surface, shared by
    the fleet and the standalone-engine CLI so the two can never
    diverge: port = explicit > CCSC_METRICSD_PORT > off (None);
    snapshot = explicit > CCSC_METRICSD_SNAPSHOT >
    metrics_dir/metrics.prom (only when the endpoint is on — a run
    that asked for nothing gets no surprise file). A snapshot
    REQUEST without a port is honored: scrape-less environments are
    the snapshot's whole point, so (None, path) means snapshot-only
    mode (:class:`MetricsD` skips the HTTP server)."""
    if port is None:
        port = _env.env_int("CCSC_METRICSD_PORT")
    snap = snapshot or _env.env_str("CCSC_METRICSD_SNAPSHOT")
    if port is None:
        return None, snap
    if snap is None and metrics_dir:
        snap = os.path.join(metrics_dir, "metrics.prom")
    return int(port), snap


def tenant_labeled_counters(
    delivered: Dict[str, int], rejected: Dict[str, int]
) -> List[Tuple[str, Dict[str, object], int]]:
    """The ONE construction of the per-tenant labeled counter series
    from {tenant: count} maps — shared by the fleet's live
    ``metrics()`` and the stream-derived :class:`StreamMetrics`, so
    the HTTP endpoint and a scrape-less snapshot can never render
    different series names or label shapes for the same state."""
    return [
        ("tenant_requests_total", {"tenant": t}, delivered[t])
        for t in sorted(delivered)
    ] + [
        ("tenant_rejected_total", {"tenant": t}, rejected[t])
        for t in sorted(rejected)
    ]


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    return repr(round(f, 6))


def _labels(labels: Optional[Dict[str, object]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(metrics: Dict, prefix: str = _PREFIX) -> str:
    """Render the shared metrics-dict shape:

    ``{"counters": {name: value}, "gauges": {name: value},
    "labeled_counters": [(name, labels_dict, value), ...],
    "histograms": [(name, labels_dict, slo-snapshot-dict), ...]}``

    as Prometheus text exposition (one stable, sorted rendering — the
    HTTP endpoint and the snapshot file emit identical bytes for
    identical state). ``labeled_counters`` is the per-tenant series
    surface (``tenant``/``bank_id`` labels, serve.tenancy): one TYPE
    line per metric name, one sample per label set."""
    lines: List[str] = []
    for kind in ("counters", "gauges"):
        ptype = "counter" if kind == "counters" else "gauge"
        for name in sorted(metrics.get(kind) or {}):
            full = f"{prefix}_{name}"
            lines.append(f"# TYPE {full} {ptype}")
            lines.append(f"{full} {_fmt(metrics[kind][name])}")
    seen_labeled = set()
    for name, labels, value in sorted(
        metrics.get("labeled_counters") or (),
        key=lambda row: (row[0], sorted((row[1] or {}).items())),
    ):
        full = f"{prefix}_{name}"
        if full not in seen_labeled:
            seen_labeled.add(full)
            lines.append(f"# TYPE {full} counter")
        lines.append(f"{full}{_labels(labels)} {_fmt(value)}")
    seen_types = set()
    for name, labels, snap in metrics.get("histograms") or ():
        full = f"{prefix}_{name}"
        if full not in seen_types:
            seen_types.add(full)
            lines.append(f"# TYPE {full} histogram")
        bounds = snap.get("bounds_ms") or []
        counts = snap.get("counts") or []
        cum = 0
        for i, b in enumerate(bounds):
            cum += counts[i] if i < len(counts) else 0
            lab = dict(labels or {})
            lab["le"] = _fmt(float(b))
            lines.append(f"{full}_bucket{_labels(lab)} {cum}")
        if len(counts) > len(bounds):
            cum += counts[len(bounds)]
        lab = dict(labels or {})
        lab["le"] = "+Inf"
        lines.append(f"{full}_bucket{_labels(lab)} {cum}")
        lines.append(
            f"{full}_sum{_labels(labels)} {_fmt(snap.get('sum_ms', 0.0))}"
        )
        lines.append(
            f"{full}_count{_labels(labels)} {snap.get('n', cum)}"
        )
    return "\n".join(lines) + "\n"


def parse_snapshot_stamp(path: str) -> Optional[Dict[str, object]]:
    """Read the freshness stamp back out of a snapshot file:
    ``{"timestamp": ..., "age_s": ..., "run_id": ...}`` — or None
    when the file is absent or predates the stamp. The staleness
    judgment belongs to the READER (``scripts/obs_report.py`` flags a
    snapshot whose timestamp lags the wall clock): a static file
    cannot know how long ago it was written."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            text = f.read()
    except OSError:
        return None
    out: Dict[str, object] = {}
    for line in text.splitlines():
        if line.startswith("ccsc_snapshot_timestamp_seconds "):
            try:
                out["timestamp"] = float(line.split()[-1])
            except ValueError:
                pass
        elif line.startswith("ccsc_snapshot_age_seconds "):
            try:
                out["age_s"] = float(line.split()[-1])
            except ValueError:
                pass
        elif line.startswith("ccsc_snapshot_info{"):
            lo = line.find('run_id="')
            if lo >= 0:
                hi = line.find('"', lo + 8)
                if hi > lo:
                    out["run_id"] = line[lo + 8:hi]
    return out if "timestamp" in out else None


class StreamMetrics:
    """Metrics source derived from an obs event stream on disk.

    Tails the stream INCREMENTALLY (``utils.obs.EventTail``,
    recursive so a fleet dir's ``replica-NN/`` streams merge): each
    call consumes only appended records, folds them into running
    counters, and keeps the newest ``slo_histogram`` snapshot per
    (phase, replica) — so a scrape of a day-old stream costs what the
    last few seconds wrote, not the whole file."""

    def __init__(self, metrics_dir: str):
        from ..utils import obs

        self._dir = metrics_dir
        self._tail = obs.EventTail(metrics_dir, recursive=True)
        # fleet mode is LATCHED (structurally from replica-NN subdirs,
        # or from the first fleet_request): a Prometheus counter must
        # never decrease, and flipping from the engine-side count to
        # the (briefly lower) fleet-side delivered count mid-stream
        # would read as a process restart to rate()/increase()
        self._fleet_mode = self._is_fleet_dir()
        self._counters: Dict[str, int] = {
            "dispatches_total": 0,
            "requeued_total": 0,
            "rejected_total": 0,
            "duplicates_suppressed_total": 0,
            "slo_breaches_total": 0,
            "probe_failures_total": 0,
            # request-lifecycle folds (serve.fleet hedging/deadlines):
            # same names the live fleet.metrics() surface exports, so
            # a stream-derived scrape and an in-process scrape render
            # identical ccsc_* series
            "hedges_total": 0,
            "hedge_wins_total": 0,
            "deadline_exceeded_total": 0,
            "cancelled_total": 0,
        }
        # quality plane folds (serve.quality): breached tenant floors
        # (gauge parity with the live fleet's n_breached — a floor
        # never un-breaches within a run) and the newest psnr_db
        # histogram per (bank, tenant, bucket, replica)
        self._breached_tenants: set = set()
        self._qhists: Dict[Tuple, Dict] = {}
        # a fleet dir carries BOTH record kinds for one delivery —
        # fleet_request at the top level, serve_request in the
        # replica's stream — so the two are counted separately and
        # the mode is picked at READ time: any fleet_request ever
        # seen means the fleet count is the request count (counting
        # serve_request until the first fleet_request arrives would
        # double-count every early delivery)
        self._n_fleet_req = 0
        self._n_serve_req = 0
        # per-tenant folds (serve.tenancy): delivered and
        # quota-rejected counts, rendered as labeled counter series
        self._tenant_req: Dict[str, int] = {}
        self._tenant_rej: Dict[str, int] = {}
        self._hists: Dict[Tuple[str, object, object], Dict] = {}
        self._lock = threading.Lock()

    def _is_fleet_dir(self) -> bool:
        try:
            return any(
                name.startswith("replica-")
                and os.path.isdir(os.path.join(self._dir, name))
                for name in os.listdir(self._dir)
            )
        except OSError:
            return False

    def __call__(self) -> Dict:
        with self._lock:
            if not self._fleet_mode:
                self._fleet_mode = self._is_fleet_dir()
            for rec in self._tail.poll():
                kind = rec.get("type")
                if kind == "fleet_request":
                    self._fleet_mode = True
                    self._n_fleet_req += 1
                    t = rec.get("tenant")
                    if t:
                        self._tenant_req[t] = (
                            self._tenant_req.get(t, 0) + 1
                        )
                elif kind == "serve_request":
                    self._n_serve_req += 1
                elif kind == "serve_dispatch":
                    self._counters["dispatches_total"] += 1
                elif kind == "fleet_requeue":
                    self._counters["requeued_total"] += int(
                        rec.get("n", 0)
                    )
                elif kind == "fleet_admission_reject":
                    self._counters["rejected_total"] += 1
                elif kind == "tenant_reject":
                    t = rec.get("tenant")
                    if t:
                        self._tenant_rej[t] = (
                            self._tenant_rej.get(t, 0) + 1
                        )
                elif kind == "fleet_duplicate_suppressed":
                    self._counters["duplicates_suppressed_total"] += 1
                elif kind == "slo_breach":
                    self._counters["slo_breaches_total"] += 1
                elif kind == "slo_histogram":
                    key = (
                        str(rec.get("phase", "total")),
                        rec.get("replica_id"),
                        rec.get("tenant"),
                    )
                    self._hists[key] = rec
                elif kind == "quality_probe_breach":
                    self._counters["probe_failures_total"] += 1
                elif kind == "hedge_spawn":
                    self._counters["hedges_total"] += 1
                elif kind == "hedge_win":
                    self._counters["hedge_wins_total"] += 1
                elif kind == "deadline_exceeded":
                    self._counters["deadline_exceeded_total"] += 1
                elif kind == "request_cancelled":
                    self._counters["cancelled_total"] += 1
                elif kind == "quality_breach":
                    t = rec.get("tenant")
                    if t:
                        self._breached_tenants.add(t)
                elif kind == "quality_histogram":
                    qkey = (
                        rec.get("bank_id"),
                        rec.get("tenant"),
                        rec.get("bucket"),
                        rec.get("replica_id"),
                    )
                    self._qhists[qkey] = rec
            hists = []
            for (phase, rid, tenant), rec in sorted(
                self._hists.items(), key=lambda kv: str(kv[0])
            ):
                labels = {"phase": phase}
                if rid is not None:
                    labels["replica"] = rid
                if tenant is not None:
                    labels["tenant"] = tenant
                hists.append(("latency_ms", labels, rec))
            # psnr_db series mirror the live metrics() label shape
            # ({bank_id, tenant, bucket}); a replica label is added
            # only for replica-scope rows so the fleet-scope series
            # renders identically to the in-memory source
            for (bank, tenant, bucket, rid), rec in sorted(
                self._qhists.items(), key=lambda kv: str(kv[0])
            ):
                labels = {
                    "bank_id": bank, "tenant": tenant,
                    "bucket": bucket,
                }
                if rid is not None:
                    labels["replica"] = rid
                hists.append(("psnr_db", labels, rec))
            counters = dict(self._counters)
            counters["requests_total"] = (
                self._n_fleet_req
                if self._fleet_mode
                else self._n_serve_req
            )
            labeled = tenant_labeled_counters(
                self._tenant_req, self._tenant_rej
            )
            return {
                "counters": counters,
                "gauges": {
                    "quality_breach": len(self._breached_tenants),
                },
                "labeled_counters": labeled,
                "histograms": hists,
            }


class _Handler(BaseHTTPRequestHandler):
    server_version = "ccsc-metricsd"

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            body = self.server._render().encode("utf-8")  # type: ignore[attr-defined]
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception:  # pragma: no cover - a broken scrape must
            # never take the server thread down
            try:
                self.send_error(500)
            except Exception:
                pass

    def log_message(self, *args):  # silence per-scrape stderr noise
        pass


class MetricsD:
    """The live surface: HTTP endpoint + atomic snapshot file.

    ``source`` is a callable returning the shared metrics-dict shape
    (``ServeFleet.metrics`` / ``CodecEngine.metrics``) or a metrics
    dir (wrapped in :class:`StreamMetrics`). ``port`` 0 binds an
    ephemeral port; the bound port is ``self.port`` after
    ``start()``; ``port=None`` is snapshot-only mode (no HTTP server
    — a scrape-less environment that only wants the atomic file).
    Both background threads are tracked and joined by ``stop()`` — a
    leaked daemon thread at interpreter exit is the failure class the
    thread-safety lint exists for."""

    def __init__(
        self,
        source: Union[Callable[[], Dict], str],
        port: Optional[int] = 0,
        host: str = "127.0.0.1",
        snapshot_path: Optional[str] = None,
        interval_s: Optional[float] = None,
        run_id: Optional[str] = None,
    ):
        if isinstance(source, str):
            source = StreamMetrics(source)
        self._source = source
        self._host = host
        self._req_port = None if port is None else int(port)
        self.snapshot_path = snapshot_path
        if interval_s is None:
            interval_s = _env.env_float("CCSC_METRICSD_INTERVAL_S")
        self.interval_s = max(0.05, float(interval_s))
        # run identity stamped into every exposition: a scrape-less
        # reader of metrics.prom can tell whether the file belongs to
        # the fleet it thinks is alive, or is the husk of a dead one
        self.run_id = run_id or f"pid-{os.getpid()}"
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._snap_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # freshness tracking: _last_change is the newest time the
        # UNSTAMPED body actually differed — a live metricsd sitting
        # on a dead source (a sidecar tailing a stream that stopped)
        # shows a growing ccsc_snapshot_age_seconds; a dead metricsd
        # shows a frozen ccsc_snapshot_timestamp_seconds readers
        # compare against the wall clock
        self._last_body: Optional[str] = None
        self._last_change = time.time()

    def render(self) -> str:
        body = render_prometheus(self._source())
        now = time.time()
        if body != self._last_body:
            self._last_body = body
            self._last_change = now
        stamp = [
            # snapshot-format version stamp: readers that care about
            # the exposition shape (format 2 added labeled per-tenant
            # counter series, format 3 the quality plane series) can
            # branch on it; parse_snapshot_stamp ignores it — the
            # freshness contract is unchanged
            "# TYPE ccsc_snapshot_format gauge",
            f"ccsc_snapshot_format {SNAPSHOT_FORMAT}",
            "# TYPE ccsc_snapshot_timestamp_seconds gauge",
            f"ccsc_snapshot_timestamp_seconds {_fmt(now)}",
            "# TYPE ccsc_snapshot_age_seconds gauge",
            "ccsc_snapshot_age_seconds "
            f"{_fmt(max(0.0, now - self._last_change))}",
            "# TYPE ccsc_snapshot_info gauge",
            f'ccsc_snapshot_info{{run_id="{self.run_id}"}} 1',
        ]
        return body + "\n".join(stamp) + "\n"

    def write_snapshot(self) -> None:
        """One atomic exposition write (tmp + rename): a reader can
        never observe a torn file."""
        if not self.snapshot_path:
            return
        body = self.render()
        d = os.path.dirname(os.path.abspath(self.snapshot_path))
        os.makedirs(d, exist_ok=True)
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(body)
        os.replace(tmp, self.snapshot_path)

    def _snap_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_snapshot()
            except Exception:  # pragma: no cover - disk-full etc.;
                pass  # the endpoint stays up regardless

    def start(self) -> "MetricsD":
        if self._req_port is not None:
            srv = ThreadingHTTPServer(
                (self._host, self._req_port), _Handler
            )
            srv.daemon_threads = True
            srv._render = self.render  # type: ignore[attr-defined]
            self._server = srv
            self.port = srv.server_address[1]
            self._server_thread = threading.Thread(
                target=srv.serve_forever, name="ccsc-metricsd",
                daemon=True,
            )
            self._server_thread.start()
        if self.snapshot_path:
            try:
                self.write_snapshot()  # a snapshot exists from t=0
                self._snap_thread = threading.Thread(
                    target=self._snap_loop,
                    name="ccsc-metricsd-snap",
                    daemon=True,
                )
                self._snap_thread.start()
            except BaseException:
                # callers treat a start() failure as "no surface" and
                # drop the instance — the server started above must
                # not outlive that decision as an ownerless daemon
                # squatting the port
                self.stop()
                raise
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:  # pragma: no cover
                pass
        if self._server_thread is not None:
            self._server_thread.join(timeout=5.0)
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=5.0)
            try:
                self.write_snapshot()  # final state on disk
            except Exception:  # pragma: no cover
                pass

    def __enter__(self) -> "MetricsD":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
