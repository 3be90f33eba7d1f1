"""The port's telemetry primitives (``utils.obs``, ``utils.trace``,
``serve.slo``, ``analysis.obs_schema``, ``utils.perfmodel``,
``utils.memwatch``, ``utils.display``, ``utils.profiling``) on the CPU.

The modules copied from the JAX package are held to it on the same
inputs, exactly: the schema registry, the SLO histogram's snapshots,
round trips and percentiles, the span reassembly, the filter mosaic and
the analytic outer-step cost. The stream primitives mirror the JAX
package's own tests (tests/test_obs.py): a schema round trip, a torn
trailing line dropped, ``EventTail`` across a rotation, a null run that
writes nothing, the heartbeat cadence. Then what the port adds: the
kernel-library compile records, the PNG figures without matplotlib, the
H100 roofline row and its float32 bound, and a memory watermark that
reads the allocator's peak and never resets it.
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.analysis import obs_schema as jschema
from ccsc_code_iccv2017_tpu.serve import slo as jslo
from ccsc_code_iccv2017_tpu.utils import display as jdisplay
from ccsc_code_iccv2017_tpu.utils import perfmodel as jperf
from ccsc_code_iccv2017_tpu.utils import trace as jtrace
from ccsc_code_iccv2017_torch.analysis import obs_schema
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.serve import slo
from ccsc_code_iccv2017_torch.utils import (
    display, memwatch, obs, perfmodel, profiling, trace,
)


def _by_type(events):
    by = {}
    for e in events:
        by.setdefault(e["type"], []).append(e)
    return by


def test_event_schema_equals_jax():
    assert obs_schema.EVENT_SCHEMA == jschema.EVENT_SCHEMA
    assert obs_schema.required_fields("step") == frozenset({"it"})


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_histogram_matches_jax(seed):
    """Snapshots equal, the snapshot round trip, and percentiles equal,
    both ways across the packages (exact: the same code on the same
    floats)."""
    vals = np.random.default_rng(seed).lognormal(3.0, 1.5, 500).tolist()
    h, jh = slo.Histogram.of(vals), jslo.Histogram.of(vals)
    assert h.snapshot() == jh.snapshot()
    for q in (0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == jh.percentile(q)
        assert h.percentile_floor(q) == jh.percentile_floor(q)
        assert slo.from_snapshot(h.snapshot()).percentile(q) == \
            jslo.from_snapshot(h.snapshot()).percentile(q)
    back = jslo.from_snapshot(json.loads(json.dumps(h.snapshot())))
    assert (back.counts, back.n) == (h.counts, h.n)
    assert slo.DEFAULT_BOUNDS_MS == jslo.DEFAULT_BOUNDS_MS


def test_slo_monitor_breach_matches_jax():
    mons = [mod.SloMonitor({0.99: 5.0}, check_s=0.0)
            for mod in (slo, jslo)]
    for m in mons:
        for v in (1.0, 2.0, 50.0):
            m.observe("total", v)
    got = [m.tick(now=1.0) for m in mons]
    assert got[0] == got[1] and got[0][0]


def _span_events(mod):
    """One complete request story and one broken one, written through
    ``mod``'s emitters into a list."""
    out = []

    def emit(type_, **f):
        out.append(dict(type=type_, t=f.get("ts", 0.0), **f))

    root = mod.emit_span(emit, trace_id="a", span="request", t_start=1.0,
                         t_end=4.0, span_id="r1")
    mod.emit_span(emit, trace_id="a", span="engine_queue", parent_span=root,
                  t_start=1.0, t_end=2.0, span_id="q1")
    mod.emit_span(emit, trace_id="a", span="solve", parent_span=root,
                  t_start=2.0, t_end=4.0, span_id="s1", bucket="2@8x8",
                  iters=7)
    mod.start_span(emit, trace_id="b", span="request", span_id="r2", ts=5.0)
    return out


def test_trace_assemble_matches_jax():
    ev = _span_events(trace)
    assert ev == _span_events(jtrace)
    got, ref = trace.assemble(ev), jtrace.assemble(ev)
    assert sorted(got) == sorted(ref) == ["a", "b"]
    for tid in got:
        g, r = got[tid], ref[tid]
        assert g.complete == r.complete
        assert g.duration_ms == r.duration_ms
        assert {k: (s.name, s.parent_span, s.dur_ms, s.status, s.fields)
                for k, s in g.spans.items()} == \
            {k: (s.name, s.parent_span, s.dur_ms, s.status, s.fields)
             for k, s in r.spans.items()}
        assert trace.render_timeline(g) == jtrace.render_timeline(r)
    assert got["a"].complete and not got["b"].complete


@pytest.mark.parametrize("shape", [(7, 3, 3), (4, 5, 6), (5, 2, 4, 4)])
def test_filter_mosaic_matches_jax(shape):
    d = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(display.filter_mosaic(d),
                                  jdisplay.filter_mosaic(d))


# ------------------------------------------------------------------
# stream primitives (JAX tests/test_obs.py:54-244, :435-460)
# ------------------------------------------------------------------

def test_event_stream_schema_roundtrip(tmp_path):
    d = str(tmp_path / "metrics")
    run = obs.start_run(d, algorithm="unit", verbose="none",
                        workload="roundtrip", device="cpu")
    try:
        run.step(it=1, obj_d=1.5, obj_z=2.5, d_diff=0.1, z_diff=0.2)
        run.heartbeat(1, 0.01)
        run.chunk(0, 4, 4, 2.0)
        run.event("log", tier="brief", msg="x")
    finally:
        run.close(status="ok", iterations=1)
    events = obs.read_events(d)
    types = [e["type"] for e in events]
    assert types[0] == "run_meta" and types[-1] == "summary"
    meta = events[0]
    assert meta["algorithm"] == "unit" and meta["workload"] == "roundtrip"
    assert meta["platform"] == "cpu" and meta["chip"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert (meta["process_index"], meta["process_count"]) == (0, 1)
    assert "hostname" in meta and "jax_version" not in meta
    for e in events:
        assert "t" in e and "host" in e
        assert obs_schema.required_fields(e["type"]) <= set(e), e["type"]
    step = next(e for e in events if e["type"] == "step")
    assert step["it"] == 1 and step["obj_z"] == 2.5
    roof = next(e for e in events if e["type"] == "roofline")
    assert roof["it_per_sec"] == pytest.approx(2.0)
    summary = events[-1]
    assert summary["status"] == "ok" and summary["compile"]["n_compiles"] == 0


def test_torn_trailing_line_is_dropped(tmp_path):
    d = str(tmp_path / "metrics")
    run = obs.start_run(d, algorithm="unit", verbose="none", device="cpu")
    run.step(it=1, obj_z=1.0)
    run.step(it=2, obj_z=2.0)
    run.close()
    path = os.path.join(d, os.listdir(d)[0])
    with open(path, "a") as f:
        f.write('{"type": "step", "it": 3, "obj')  # torn mid-record
    assert [e["it"] for e in obs.read_events(d) if e["type"] == "step"] \
        == [1, 2]
    # a resumed writer terminates the torn tail before its first record
    run2 = obs.start_run(d, algorithm="unit", verbose="none", device="cpu")
    run2.step(it=4, obj_z=4.0)
    run2.close()
    events = obs.read_events(d)
    assert [e["it"] for e in events if e["type"] == "step"] == [1, 2, 4]
    assert len([e for e in events if e["type"] == "run_meta"]) == 2


def test_event_tail_across_a_rotation(tmp_path):
    d = str(tmp_path / "stream")
    os.makedirs(d)

    def seg(i):
        return os.path.join(d, f"events-{i:04d}.jsonl")

    def w(path, recs, torn=None):
        with open(path, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            if torn is not None:
                f.write(torn)

    tail = obs.EventTail(d)
    w(seg(0), [{"t": 1.0, "type": "step", "it": 1}])
    assert [r["it"] for r in tail.poll()] == [1]
    w(seg(0), [{"t": 2.0, "type": "step", "it": 2}],
      torn='{"t": 2.5, "type": "step", "i')
    w(seg(1), [{"t": 3.0, "type": "step", "it": 3}])
    assert [r["it"] for r in tail.poll()] == [2, 3]
    with open(seg(0), "a") as f:
        f.write("\n")
    w(seg(0), [{"t": 4.0, "type": "step", "it": 4}])
    w(seg(1), [{"t": 5.0, "type": "step", "it": 5}])
    assert [r["it"] for r in tail.poll() if "it" in r] == [4, 5]
    assert tail.poll() == []
    # a truncated file is re-read from its start
    with open(seg(1), "w") as f:
        f.write(json.dumps({"t": 6.0, "type": "step", "it": 6}) + "\n")
    assert [r["it"] for r in tail.poll()] == [6]


def test_null_run_is_inert(tmp_path, capsys):
    run = obs.start_run(None, algorithm="unit", verbose="brief")
    try:
        assert not run.active and obs.current_run() is run
        run.step(it=1, obj_z=1.0)
        run.console("hello", tier="brief")
        run.console("hidden", tier="all")
    finally:
        run.close()
    assert obs.current_run() is not run
    out = capsys.readouterr().out
    assert "hello" in out and "hidden" not in out
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("every, want", [(0.0, 3), (3600.0, 1)])
def test_heartbeat_cadence(tmp_path, monkeypatch, every, want):
    """CCSC_OBS_HEARTBEAT_S=0 beats at every fence; a long cadence beats
    once (the first fence) in a short run."""
    monkeypatch.setenv("CCSC_OBS_HEARTBEAT_S", str(every))
    d = str(tmp_path / "m")
    run = obs.start_run(d, algorithm="unit", verbose="none", device="cpu")
    for i in range(3):
        run.heartbeat(i + 1, 0.001)
    run.close()
    beats = [e for e in obs.read_events(d) if e["type"] == "heartbeat"]
    assert len(beats) == want and beats[0]["step"] == 1


def test_device_tensors_are_refused_in_records():
    """Host values serialise; a tensor on a device is refused (its value
    must come from the driver's fence, not from the stream)."""
    assert obs._json_default(torch.tensor(2.5)) == 2.5
    assert obs._json_default(np.float32(1.5)) == 1.5
    with pytest.raises(TypeError, match="read it back"):
        obs._json_default(torch.ones(1, device="meta"))


def test_git_sha_reads_only_its_own_checkout(tmp_path, monkeypatch):
    """The revision stamped into run_meta is the HEAD of the checkout
    whose top holds the package: a copy without its own .git inside
    another repository stamps None, not that repository's HEAD. The
    override wins over both."""
    import subprocess

    def git(cwd, *args):
        return subprocess.run(
            ["git", "-c", "user.name=t", "-c", "user.email=t@t", *args],
            cwd=cwd, check=True, capture_output=True, text=True,
        ).stdout.strip()

    outer, copy, inner = tmp_path / "outer", tmp_path / "outer" / "copy", \
        tmp_path / "outer" / "inner"
    copy.mkdir(parents=True)
    inner.mkdir()
    shas = {}
    for repo in (outer, inner):
        git(repo, "init", "-q")
        git(repo, "commit", "-q", "--allow-empty", "-m", "c")
        shas[repo] = git(repo, "rev-parse", "HEAD")
    assert obs._checkout_sha(str(outer)) == shas[outer]
    assert obs._checkout_sha(str(inner)) == shas[inner]
    assert obs._checkout_sha(str(copy)) is None
    monkeypatch.setenv("CCSC_GIT_SHA", "abc123")
    assert obs.git_sha() == "abc123"


# ------------------------------------------------------------------
# kernel-library compile records
# ------------------------------------------------------------------

def test_kernel_builds_and_loads_are_compile_records(tmp_path, monkeypatch):
    """``ops.kernels`` under a stand-in nvcc: the build is a ``build``
    record, each load a ``load`` record, and a library loaded twice in
    one process is flagged in the closing summary."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_LIBRARIES", {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: path)
    d = str(tmp_path / "m")
    run = obs.start_run(d, algorithm="unit", verbose="none", device="cpu")
    lib = kernels.bound_library("solve_z_rank1", lambda lib: lib)
    assert lib.endswith(".so")
    monkeypatch.setattr(kernels, "_LIBRARIES", {})  # a second load
    kernels.bound_library("solve_z_rank1", lambda lib: lib)
    run.close()
    # outside a run a load reports to no one
    kernels.bound_library("fused_z", lambda lib: lib)
    by = _by_type(obs.read_events(d))
    assert [(c["kind"], c["fun_name"]) for c in by["compile"]] == [
        ("build", "solve_z_rank1"), ("load", "solve_z_rank1"),
        ("load", "solve_z_rank1")]
    for c in by["compile"]:
        assert c["duration_s"] >= 0.0
    summ = by["summary"][0]["compile"]
    assert summ["n_compiles"] == 3 and summ["n_builds"] == 1
    assert summ["compiles_by_fun"] == {"solve_z_rank1": 2}
    assert summ["recompiled_funs"] == ["solve_z_rank1"]


# ------------------------------------------------------------------
# perfmodel
# ------------------------------------------------------------------

COST_CASES = {
    # the BASELINE.md north star: 8 blocks x 100 images of 100x100
    # (110x110 padded), k=100 11x11, fused_z on and off
    "north_star_fused": dict(num_blocks=8, ni=100, k=100, spatial=(110, 110),
                             num_freq=110 * 56, max_it_d=5, max_it_z=10,
                             fused_z=True),
    "north_star": dict(num_blocks=8, ni=100, k=100, spatial=(110, 110),
                       num_freq=110 * 56, max_it_d=5, max_it_z=10),
    "small_fused_bf16": dict(num_blocks=2, ni=2, k=6, spatial=(20, 20),
                             num_freq=20 * 11, max_it_d=3, max_it_z=3,
                             fused_z=True, state_dtype_bytes=2,
                             d_state_dtype_bytes=2),
    "hyperspectral": dict(num_blocks=1, ni=4, k=8, spatial=(16, 16),
                          num_freq=16 * 9, max_it_d=2, max_it_z=2,
                          reduce_size=31, donate_state=True),
    "3d": dict(num_blocks=2, ni=3, k=4, spatial=(8, 8, 6),
               num_freq=8 * 8 * 4, max_it_d=2, max_it_z=4),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_analytic_outer_step_cost_equals_jax(case):
    kw = COST_CASES[case]
    assert perfmodel.analytic_outer_step_cost(**kw) == \
        jperf.analytic_outer_step_cost(**kw)


def test_chip_rows_and_the_float32_bound():
    assert perfmodel.detect_chip("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert perfmodel.detect_chip() == "cpu"
    assert set(perfmodel.CHIP_PEAKS) == {"h100", "cpu"}
    h = perfmodel.CHIP_PEAKS["h100"]
    assert h == {"flops_bf16": 989.4e12, "flops_f32": 66.9e12,
                 "hbm_gbps": 3.35e12}
    cost = perfmodel.analytic_outer_step_cost(**COST_CASES["north_star"])
    want = 1.0 / max(cost["flops"] / 66.9e12, cost["bytes"] / 3.35e12)
    assert perfmodel.bound_iters_per_sec(cost, "h100") == want
    # an unknown card is scored against the H100 row, labeled so
    assert perfmodel.bound_iters_per_sec(cost, "A100->h100") == want
    u = perfmodel.utilization(cost, 2.0, chip="NVIDIA A100")
    assert u["chip"] == "NVIDIA A100->h100"
    assert u["mfu_vs_bf16_peak"] == cost["flops"] * 2.0 / 989.4e12
    assert u["hbm_frac"] == cost["bytes"] * 2.0 / 3.35e12
    assert perfmodel.serving_bound(300.0, 60.0, 4) == \
        jperf.serving_bound(300.0, 60.0, 4)


def test_inmem_estimate_equals_jax():
    from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
    from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom

    kw = dict(num_blocks=2, storage_dtype="bfloat16")
    shape = (8, 20, 20)
    # the JAX function returns (bytes, budget); the port the bytes alone
    assert perfmodel.inmem_learn_estimate(
        shape, ProblemGeom((5, 5), 6), LearnConfig(**kw)) == \
        jperf.inmem_learn_estimate(shape, JGeom((5, 5), 6), JCfg(**kw))[0]


# ------------------------------------------------------------------
# memwatch
# ------------------------------------------------------------------

class _FakeCard:
    """A device whose allocator stats are read, and which records any
    attempt to write them."""

    def __init__(self, id_, peak):
        self.id = id_
        self.peak = peak
        self.calls = []

    def memory_stats(self):
        self.calls.append("memory_stats")
        return {"allocated_bytes.all.peak": self.peak,
                "allocated_bytes.all.current": self.peak // 2,
                "reserved_bytes.all.peak": 2 * self.peak}

    def __getattr__(self, name):  # reset_peak_memory_stats et al.
        raise AssertionError(f"memwatch called {name} on the device")


def test_memwatch_on_the_cpu_does_nothing():
    mw = memwatch.MemWatch(devices=[torch.device("cpu")], enabled=True)
    assert mw.sample() is None
    assert mw.peak_bytes is None and mw.watermark_record() is None


def test_memwatch_reads_the_peak_and_never_resets_it(monkeypatch):
    cards = [_FakeCard(0, 1000), _FakeCard(1, 3000)]
    mw = memwatch.MemWatch(devices=cards, enabled=True)
    assert mw.sample() == 2000
    cards[0].peak = 5000
    mw.sample()
    assert (mw.peak_bytes, mw.total_peak_bytes) == (5000, 8000)
    assert mw.reserved_peak_bytes == 10000
    rec = mw.watermark_record(modeled_bytes=4000)
    assert rec["peak_hbm_bytes"] == 5000 and rec["n_samples"] == 2
    assert rec["delta_frac"] == 1.0 and rec["flagged"]
    assert all(c.calls == ["memory_stats"] * 2 for c in cards)
    # nothing in the module can reset the caller's peak
    import inspect

    assert "reset_peak_memory_stats(" not in inspect.getsource(memwatch)
    monkeypatch.setenv("CCSC_MEMWATCH", "0")
    off = memwatch.MemWatch(devices=cards)
    assert off.sample() is None and off.peak_bytes is None


def test_oom_is_recognised_and_dumped(tmp_path):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to ...")
    assert memwatch.is_oom(oom)
    assert not memwatch.is_oom(ValueError("shape"))
    assert memwatch.oom_dump(ValueError("x"), str(tmp_path)) is None
    path = memwatch.oom_dump(oom, str(tmp_path), devices=[_FakeCard(0, 7)])
    with open(path) as f:
        dump = json.load(f)
    assert "OutOfMemoryError" in dump["error"]
    assert dump["devices"][0]["stats"]["allocated_bytes.all.peak"] == 7


# ------------------------------------------------------------------
# figures and the profiler
# ------------------------------------------------------------------

def read_png(path):
    """-> (gray uint8 array, {tEXt keyword: text}); checks the signature
    and every chunk's CRC."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, text, ihdr = 8, b"", {}, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"tEXt":
            k, v = body.split(b"\x00", 1)
            text[k.decode()] = v.decode("latin-1")
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    assert (depth, color) == (8, 0)
    raw = zlib.decompress(idat)
    assert len(raw) == h * (w + 1)
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()  # filter type None on every row
    return rows[:, 1:], text


def test_png_figures_without_matplotlib(tmp_path):
    d = np.random.default_rng(0).normal(size=(5, 3, 3)).astype(np.float32)
    p = str(tmp_path / "filters_001.png")
    display.save_filter_mosaic(p, d, title="iter 1")
    img, text = read_png(p)
    assert img.shape == display.filter_mosaic(d).shape
    assert text == {"Title": "iter 1"}
    assert img.min() == 0 and img.max() == 255
    q = str(tmp_path / "iterates_001.png")
    x = [np.arange(20.0).reshape(4, 5)] * 2
    display.save_iterate_panel(q, x, [v * 2 for v in x], title="iter 1")
    img, text = read_png(q)
    assert img.shape == (2 * 6 + 2, 2 * 7 + 2)


def test_a_second_profiler_is_refused(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.profiler_active()
        with pytest.raises(RuntimeError, match="already recording"):
            with profiling.xla_trace(str(tmp_path / "p"), "cpu"):
                pass
    assert not profiling.profiler_active()
    with profiling.xla_trace(str(tmp_path / "p"), "cpu"):
        with profiling.annotate("ccsc_unit_span"):
            torch.ones(3).sum()
    (name,) = os.listdir(tmp_path / "p")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "p" / name) as f:
        assert "ccsc_unit_span" in f.read()
