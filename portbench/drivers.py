"""The general traffic generator: one driver per kind of load, each read
from a traffic file's parameters (``portbench/traffic/<mix>.json``).

- ``open_loop``: independent users. ``rate_rps`` arrivals a second for
  the window, gaps the exponential law's mid-quantiles in an order drawn
  from the mix's ``arrival_seed``: every seed offers the same arrivals,
  and the seed draws which request comes at each. Each request is timed
  from when it was due, so a stall counts against every later request.
- ``closed_loop``: ``clients`` callers, each sending its next request
  when its last one returned; timed from the send.

Requests cycle through a pool of ``pool`` distinct requests made from
the seed; ``submit(j)`` sends pool entry j and returns a Future. A
traced run's profiled stretch starts ``trace_at`` seconds into the
window; the caller stops it once the window's results are in.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Tuple

from . import inputs

RESULT_WAIT_S = 60.0  # how long past the window a late result is awaited


def _record(j: int, due: float) -> dict:
    return {"pool": j, "due": due, "submit": None, "done": None,
            "result": None, "error": None}


def _send(rec: dict, submit: Callable[[int], Future], tracer) -> Future:
    def done(f: Future):
        rec["done"] = time.time()
        exc = f.exception()
        if exc is None:
            rec["result"] = f.result()
        else:
            rec["error"] = repr(exc)

    rec["submit"] = time.time()
    with tracer.span("submit"):
        fut = submit(rec["pool"])
    fut.add_done_callback(done)
    return fut


def _await(futs: List[Future], deadline: float, tracer) -> None:
    with tracer.span("result_wait"):
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - time.time()))
            except Exception:  # noqa: BLE001 - counted as failed by the caller
                pass


def open_loop(traffic: dict, submit, seed: int, seconds: float,
              tracer, trace_at) -> Tuple[float, List[dict]]:
    """Offer the window's arrivals on schedule; returns the window's
    start (epoch s) and a record per request, every one resolved or
    given up RESULT_WAIT_S after the window."""
    n = inputs.window_count(traffic["rate_rps"], seconds)
    gaps = inputs.poisson_gaps(traffic["arrival_seed"], n, seconds)
    order = inputs.rng(seed).permutation(n) % traffic["pool"]
    t0 = time.time()
    due = t0 + gaps.cumsum() - gaps[0]
    recs, futs = [], []
    marks = [(t0 + trace_at, "start", -1)] if tracer.enabled else []
    events = sorted([(d, "send", i) for i, d in enumerate(due)] + marks)
    for when, what, i in events:
        wait = when - time.time()
        if wait > 0:
            time.sleep(wait)
        if what == "start":
            tracer.start()
        else:
            rec = _record(int(order[i]), float(due[i]))
            recs.append(rec)
            futs.append(_send(rec, submit, tracer))
    t1 = t0 + seconds
    if t1 > time.time():
        time.sleep(t1 - time.time())
    _await(futs, t1 + RESULT_WAIT_S, tracer)
    return t0, recs


def closed_loop(traffic: dict, submit, seed: int, seconds: float,
                tracer, trace_at) -> Tuple[float, List[dict]]:
    """``clients`` callers send back to back until the window closes;
    the profiled stretch starts between requests of the first caller."""
    clients = int(traffic.get("clients", 1))
    order = inputs.rng(seed).permutation(traffic["pool"])
    t0 = time.time()
    t1 = t0 + seconds
    recs: List[dict] = []
    lock = threading.Lock()
    counter = [0]

    def caller(first: bool):
        while time.time() < t1:
            if first and time.time() >= t0 + trace_at:
                tracer.start()
            with lock:
                j = int(order[counter[0] % len(order)])
                counter[0] += 1
                rec = _record(j, time.time())
                recs.append(rec)
            _await([_send(rec, submit, tracer)], t1 + RESULT_WAIT_S, tracer)

    others = [threading.Thread(target=caller, args=(False,), daemon=True)
              for _ in range(clients - 1)]
    for t in others:
        t.start()
    caller(True)
    for t in others:
        t.join(timeout=RESULT_WAIT_S + seconds)
    return t0, recs


DRIVERS = {"open_loop": open_loop, "closed_loop": closed_loop}
