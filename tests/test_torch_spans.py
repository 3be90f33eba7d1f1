"""The port's spans and counters on the CPU: ``utils.profiling.annotate``
(the shared null context while nothing records, a span on any thread
while a capture records), the serving engine's spans on the thread that
runs each phase in a capture started on another, one ``ccsc.solve.read``
an iteration, and the always-on counters (``ServedResult.submit_s``, the
dispatch log's ``launch_s`` / ``deliver_s`` / ``t_solve0`` /
``t_solve1``) present and ordered."""
import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_torch import serve
from ccsc_code_iccv2017_torch.config import ProblemGeom, ServeConfig, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as tr
from ccsc_code_iccv2017_torch.utils import profiling

CALLER = ("ccsc.engine.submit", "ccsc.engine.validate", "ccsc.engine.to_host")
WORKER = ("ccsc.engine.launch", "ccsc.engine.solve", "ccsc.engine.deliver",
          "ccsc.solve.read")


def _bank():
    r = np.random.default_rng(0)
    d = r.normal(size=(6, 5, 5)).astype(np.float32)
    return d / np.sqrt((d ** 2).sum(axis=(1, 2), keepdims=True))


def _requests(n, size=24):
    r = np.random.default_rng(1)
    return [(r.random((size, size)).astype(np.float32),
             (r.random((size, size)) < 0.5).astype(np.float32))
            for _ in range(n)]


def _cfg():
    return SolveConfig(lambda_residual=5.0, lambda_prior=0.3, max_it=6,
                       tol=1e-4, verbose="none")


def _engine(d):
    return serve.CodecEngine(
        d, tr.ReconstructionProblem(ProblemGeom((5, 5), 6)), _cfg(),
        ServeConfig(buckets=((2, (24, 24)),), max_wait_ms=5.0,
                    verbose="none"),
        device="cpu")


def _spans(log_dir):
    """The capture's ``ccsc.*`` spans: (name, thread id, start, end) in
    microseconds, by start."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
                   for e in events
                   if e.get("name", "").startswith("ccsc.")
                   and e.get("ph") == "X"), key=lambda s: s[2])


def test_annotate_is_the_shared_null_context_when_nothing_records():
    a, b = profiling.annotate("ccsc.a"), profiling.annotate("ccsc.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    seen = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        # the gate is process-wide: another thread opens a real span
        t = threading.Thread(
            target=lambda: seen.append(profiling.annotate("ccsc.c")))
        t.start()
        t.join()
    assert not isinstance(seen[0], contextlib.nullcontext)
    assert profiling.annotate("ccsc.d") is a


def test_engine_spans_land_on_their_threads(tmp_path):
    """Three requests, one at a time, in a capture the caller's thread
    starts: the submit's spans on the caller, the dispatch's on the
    worker, and in each solve span one read an iteration of its
    dispatch."""
    eng = _engine(_bank())
    try:
        with profiling.xla_trace(str(tmp_path), "cpu"):
            for b, m in _requests(3):
                eng.submit(b, mask=m).result(timeout=60)
    finally:
        eng.close()
    log = eng.dispatch_log
    spans = _spans(tmp_path)
    caller, worker = threading.get_native_id(), eng._worker.native_id
    for name in CALLER + WORKER:
        tids = {s[1] for s in spans if s[0] == name}
        assert tids == {caller if name in CALLER else worker}, name
    for name in CALLER:
        assert sum(s[0] == name for s in spans) == 3, name
    subs = [s for s in spans if s[0] == "ccsc.engine.submit"]
    for s in spans:
        if s[0] in CALLER[1:]:
            assert any(u[2] <= s[2] and s[3] <= u[3] for u in subs), s
    solves = [s for s in spans if s[0] == "ccsc.engine.solve"]
    assert len(solves) == len(log) == 3
    assert [sum(s[0] == n for s in spans)
            for n in ("ccsc.engine.launch", "ccsc.engine.deliver")] == [3, 3]
    reads = [s for s in spans if s[0] == "ccsc.solve.read"]
    assert [sum(lo <= r[2] and r[3] <= hi for r in reads)
            for _, _, lo, hi in solves] == [e["iters"] for e in log]
    assert len(reads) == sum(e["iters"] for e in log)


def test_plain_solve_reads_once_an_iteration():
    d = _bank()
    (b, m), = _requests(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = tr.reconstruct(b[None], d,
                             tr.ReconstructionProblem(ProblemGeom((5, 5), 6)),
                             _cfg(), mask=m[None], device="cpu")
    reads = [e for e in prof.events() if e.name == "ccsc.solve.read"]
    assert len(reads) == int(res.trace.num_iters) > 1


def test_submit_and_worker_counters_are_present_and_ordered():
    eng = _engine(_bank())
    done = []
    try:
        for b, m in _requests(3):
            t_call = time.perf_counter()
            res = eng.submit(b, mask=m).result(timeout=60)
            done.append((res, time.perf_counter() - t_call, time.time()))
    finally:
        eng.close()  # joins the worker: every delivery has ended
    log = eng.dispatch_log
    assert len(log) == 3
    for (res, call_s, t_back), e in zip(done, log):
        assert 0 < res.submit_s < call_s
        assert e["launch_s"] >= 0 and e["deliver_s"] >= 0
        assert e["t_solve0"] <= e["t_solve1"] <= t_back
        assert e["t_solve1"] - e["t_solve0"] <= e["wall_s"]
    for a, b in zip(log, log[1:]):
        assert a["t_solve1"] <= b["t_solve0"]


def test_a_capture_of_every_thread_refuses_a_second(tmp_path):
    with profiling.xla_trace(str(tmp_path / "a"), "cpu"):
        with pytest.raises(RuntimeError, match="already recording"):
            with profiling.xla_trace(str(tmp_path / "b"), "cpu"):
                pass
