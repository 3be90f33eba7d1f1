"""Request-level tracing: span events in the obs stream, reassembled
into per-request timelines (a copy of ``ccsc_code_iccv2017_tpu.utils.trace``;
the port's serving engine and fleet write the spans).

The serving stack's telemetry so far is flat: ``serve_request`` /
``fleet_request`` / ``fleet_requeue`` records share no causal linkage,
so a slow request that was admitted, requeued off a killed replica,
and re-dispatched on a recycled engine cannot be reconstructed as one
story from the stream. This module is the causal layer:

- every request submitted to :class:`~..serve.ServeFleet` (or a
  standalone :class:`~..serve.CodecEngine`) gets a ``trace_id``;
- each lifecycle phase — admission, queue wait, every replica
  ownership (including requeues after kills/stalls), the engine
  micro-batch queue, the solve, delivery — emits a ``span_start`` /
  ``span_end`` pair into the existing obs streams, carrying
  ``trace_id`` / ``span_id`` / ``parent_span`` / ``replica_id``
  (declared in ``analysis/obs_schema.py``; span conventions are
  lint-enforced);
- :func:`assemble` rebuilds the span trees from any parsed event
  stream (``obs.read_events(recursive=True)`` merges the fleet stream
  with every replica engine's stream, and spans reference each other
  across streams by id), :func:`render_timeline` renders one request's
  story, and ``scripts/obs_report.py``'s TRACES section shows the N
  slowest.

Span events are written in two styles, both reassembling identically:
*prospective* (``start_span`` now, ``end_span`` at the transition —
used for the fleet's queue and ownership spans)
and *retrospective* (:func:`emit_span` writes the start/end pair
together after the phase finished, with measured timestamps — used
inside the engine dispatch path, where a killed replica must not be
able to leave an orphan ``span_start`` behind). Prospective spans are
used only where every exit is a fleet-owned transition. Timestamps ride the
records as a ``ts`` field (epoch seconds) so emission order never has
to match span order.

Stdlib-only on purpose: the reassembler runs inside
``scripts/obs_report.py`` and tests without touching jax.
"""
from __future__ import annotations

import binascii
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = [
    "new_trace_id",
    "new_span_id",
    "start_span",
    "end_span",
    "emit_span",
    "Span",
    "Trace",
    "assemble",
    "slowest",
    "render_timeline",
]

ROOT_SPAN = "request"


def new_trace_id() -> str:
    """16-hex request identity (collision odds negligible at any
    realistic fleet lifetime; ids only need to be unique within the
    streams one report merges)."""
    return binascii.hexlify(os.urandom(8)).decode("ascii")


def new_span_id() -> str:
    return binascii.hexlify(os.urandom(6)).decode("ascii")


# ---------------------------------------------------------------------
# emission (the writer half rides any emit(type_, **fields) callable —
# serve/fleet pass their replica_id-stamping `_emit`)
# ---------------------------------------------------------------------


def start_span(
    emit: Callable[..., None],
    *,
    trace_id: str,
    span: str,
    parent_span: Optional[str] = None,
    replica_id: Optional[int] = None,
    span_id: Optional[str] = None,
    ts: Optional[float] = None,
    **fields,
) -> str:
    """Emit a ``span_start`` and return its span id (prospective
    style; the caller owes a matching :func:`end_span`)."""
    sid = span_id or new_span_id()
    rec = dict(
        trace_id=trace_id,
        span=span,
        span_id=sid,
        parent_span=parent_span,
        replica_id=replica_id,
        ts=time.time() if ts is None else float(ts),
    )
    rec.update(fields)
    emit("span_start", **rec)
    return sid


def end_span(
    emit: Callable[..., None],
    *,
    trace_id: str,
    span: str,
    span_id: str,
    parent_span: Optional[str] = None,
    replica_id: Optional[int] = None,
    status: str = "ok",
    ts: Optional[float] = None,
    t_start: Optional[float] = None,
    **fields,
) -> None:
    t_end = time.time() if ts is None else float(ts)
    rec = dict(
        trace_id=trace_id,
        span=span,
        span_id=span_id,
        parent_span=parent_span,
        replica_id=replica_id,
        status=status,
        ts=t_end,
    )
    if t_start is not None:
        rec["dur_ms"] = round((t_end - t_start) * 1e3, 3)
    rec.update(fields)
    emit("span_end", **rec)


def emit_span(
    emit: Callable[..., None],
    *,
    trace_id: str,
    span: str,
    t_start: float,
    t_end: float,
    parent_span: Optional[str] = None,
    replica_id: Optional[int] = None,
    status: str = "ok",
    span_id: Optional[str] = None,
    **fields,
) -> str:
    """Retrospective pair: start + end written together with measured
    timestamps, so a crash mid-phase can never orphan the start."""
    sid = start_span(
        emit,
        trace_id=trace_id,
        span=span,
        parent_span=parent_span,
        replica_id=replica_id,
        span_id=span_id,
        ts=t_start,
    )
    end_span(
        emit,
        trace_id=trace_id,
        span=span,
        span_id=sid,
        parent_span=parent_span,
        replica_id=replica_id,
        status=status,
        ts=t_end,
        t_start=t_start,
        **fields,
    )
    return sid


# ---------------------------------------------------------------------
# reassembly
# ---------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One reassembled span (a matched start/end pair, or half of an
    orphan)."""

    trace_id: str
    name: str
    span_id: str
    parent_span: Optional[str]
    replica_id: Optional[int] = None
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    status: Optional[str] = None
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t_start is not None and self.t_end is not None

    @property
    def dur_ms(self) -> Optional[float]:
        if not self.closed:
            return None
        return round((self.t_end - self.t_start) * 1e3, 3)


_META = ("t", "type", "host", "trace_id", "span", "span_id",
         "parent_span", "replica_id", "status", "ts", "dur_ms")


class Trace:
    """One request's reassembled span tree."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: Dict[str, Span] = {}

    @property
    def root(self) -> Optional[Span]:
        for s in self.spans.values():
            if s.name == ROOT_SPAN and s.parent_span is None:
                return s
        return None

    @property
    def orphans(self) -> List[Span]:
        """Spans missing their start or their end — a broken story."""
        return [s for s in self.spans.values() if not s.closed]

    @property
    def unparented(self) -> List[Span]:
        """Spans whose parent_span names no span in this trace (a gap
        in the tree)."""
        return [
            s
            for s in self.spans.values()
            if s.parent_span is not None and s.parent_span not in self.spans
        ]

    @property
    def complete(self) -> bool:
        """A closed root, zero orphans, zero dangling parent refs —
        the whole request story survived, gap-free."""
        root = self.root
        return (
            root is not None
            and root.closed
            and not self.orphans
            and not self.unparented
        )

    @property
    def duration_ms(self) -> Optional[float]:
        root = self.root
        return root.dur_ms if root is not None else None

    def children(self, span_id: Optional[str]) -> List[Span]:
        out = [s for s in self.spans.values() if s.parent_span == span_id]
        out.sort(key=lambda s: (s.t_start or 0.0, s.name))
        return out

    def by_name(self, name: str) -> List[Span]:
        out = [s for s in self.spans.values() if s.name == name]
        out.sort(key=lambda s: (s.t_start or 0.0))
        return out


def assemble(events: Iterable[Dict[str, Any]]) -> Dict[str, Trace]:
    """Rebuild every trace from a parsed event stream (any order,
    any stream interleaving — spans match by ``span_id``)."""
    traces: Dict[str, Trace] = {}
    for rec in events:
        kind = rec.get("type")
        if kind not in ("span_start", "span_end"):
            continue
        tid = rec.get("trace_id")
        sid = rec.get("span_id")
        if not tid or not sid:
            continue
        tr = traces.setdefault(tid, Trace(tid))
        span = tr.spans.get(sid)
        if span is None:
            span = Span(
                trace_id=tid,
                name=rec.get("span", "?"),
                span_id=sid,
                parent_span=rec.get("parent_span"),
            )
            tr.spans[sid] = span
        if rec.get("replica_id") is not None:
            span.replica_id = rec.get("replica_id")
        ts = rec.get("ts", rec.get("t"))
        if kind == "span_start":
            if span.t_start is None:
                span.t_start = ts
        else:
            # keep the FIRST end (a double end would mask a lifecycle
            # bug; the assembler records the original story)
            if span.t_end is None:
                span.t_end = ts
                span.status = rec.get("status")
        for k, v in rec.items():
            if k not in _META:
                span.fields.setdefault(k, v)
    return traces


def slowest(traces: Dict[str, Trace], n: int = 3) -> List[Trace]:
    """The n slowest COMPLETE traces by root duration (an incomplete
    trace has no honest duration to rank by)."""
    done = [t for t in traces.values() if t.complete]
    done.sort(key=lambda t: -(t.duration_ms or 0.0))
    return done[:n]


def render_timeline(tr: Trace) -> str:
    """One request's story as an indented text timeline (offsets are
    milliseconds after the root span's start)."""
    lines: List[str] = []
    root = tr.root
    t0 = root.t_start if root is not None and root.t_start else None
    if t0 is None:
        starts = [s.t_start for s in tr.spans.values() if s.t_start]
        t0 = min(starts) if starts else 0.0
    head = f"trace {tr.trace_id}"
    if root is not None and root.dur_ms is not None:
        head += f"  {root.dur_ms:.1f} ms"
    if not tr.complete:
        head += (
            f"  [INCOMPLETE: {len(tr.orphans)} orphan span(s), "
            f"{len(tr.unparented)} dangling parent ref(s)]"
        )
    lines.append(head)

    def _walk(parent: Optional[str], depth: int) -> None:
        for s in tr.children(parent):
            off = (
                f"+{(s.t_start - t0) * 1e3:8.1f}ms"
                if s.t_start is not None
                else "        ? "
            )
            dur = f"{s.dur_ms:8.1f}ms" if s.dur_ms is not None else "   OPEN  "
            who = (
                f" r{s.replica_id}" if s.replica_id is not None else ""
            )
            extra = ""
            if "attempt" in s.fields:
                extra += f" attempt={s.fields['attempt']}"
            if "bucket" in s.fields:
                extra += f" bucket={s.fields['bucket']}"
            lines.append(
                f"  {off}  {'  ' * depth}{s.name:<14} {dur} "
                f"{s.status or '?'}{who}{extra}"
            )
            _walk(s.span_id, depth + 1)

    _walk(None, 0)
    # spans whose parent ref dangles never appear under _walk — they
    # are part of the (broken) story, render them flat at the end
    for s in tr.unparented:
        dur = f"{s.dur_ms:8.1f}ms" if s.dur_ms is not None else "   OPEN  "
        lines.append(
            f"  (dangling)  {s.name:<14} {dur} {s.status or '?'} "
            f"parent={s.parent_span}"
        )
    return "\n".join(lines)
