"""The port's autotuner (tune.space, tune.store, tune.autotune), mirroring
the JAX package's tests/test_autotune.py on the CPU: the knob tables and
their drift guard over the port's own configs, arm application, the
store's ranking and refusals (another chip's entry, a stale
fingerprint), the resolver and its numerics guard, a sweep with an
injected timer and a real CPU sweep into ``tmp_path``, and tuning in the
serving engine, ``reconstruct`` and a learner app.

Hermetic: every store lives in ``tmp_path`` and the chip is pinned; the
repo's ``tuned_knobs.json`` (the JAX package's TPU store) is never read.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu import config as jconfig
from ccsc_code_iccv2017_tpu.tune import space as jspace
from ccsc_code_iccv2017_torch import config
from ccsc_code_iccv2017_torch.config import (GEOM_2D, LearnConfig,
                                             ProblemGeom, ServeConfig,
                                             SolveConfig)
from ccsc_code_iccv2017_torch.tune import autotune, space
from ccsc_code_iccv2017_torch.tune import store as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    for v in ("CCSC_TUNE_CHIP", "CCSC_TUNE_GUARD", "CCSC_TUNE_GUARD_TOL",
              "CCSC_TUNE_MIN_WIN", "CCSC_TUNE_FP", "CCSC_HERM_INV",
              "CCSC_COMPILE_CACHE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("CCSC_TUNE_STORE", str(tmp_path / "default.json"))


def _unit_bank(k=4, sup=5, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, sup, sup)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


# ---------------------------------------------------------------------
# arm space + drift guard
# ---------------------------------------------------------------------

def test_tune_off_is_the_default():
    assert LearnConfig().tune == "off"
    assert SolveConfig().tune == "off"
    assert ServeConfig(buckets=((1, (8, 8)),)).tune == "off"
    with pytest.raises(ValueError):
        LearnConfig(tune="fastest")
    with pytest.raises(ValueError):
        SolveConfig(tune="fastest")


def test_every_config_field_is_classified():
    """The drift guard over the port's own configs: every LearnConfig /
    SolveConfig field is a knob or has its reason."""
    for kind, cls in (("learn", config.LearnConfig),
                      ("solve", config.SolveConfig)):
        unclassified, missing = space.classify_drift(kind, cls)
        assert not unclassified, sorted(unclassified)
        assert not missing, sorted(missing)


def test_use_pallas_is_not_tuned_and_the_rest_is_jax():
    """The one divergence from JAX's table: the port never reads
    use_pallas, so no arm moves it. Every other knob, value and
    workload gate is JAX's, and so is SPACE_VERSION; the fingerprints
    differ because the tables do."""
    assert "use_pallas" not in space.SOLVE_KNOBS
    assert "use_pallas" in space.NON_TUNED_SOLVE
    assert "use_pallas" in jspace.SOLVE_KNOBS
    for kind in ("learn", "solve"):
        mine = {n: k for n, k in space.knobs(kind).items()}
        theirs = {n: k for n, k in jspace.knobs(kind).items()
                  if n != "use_pallas"}
        assert {n: (k.values, k.field, k.env, k.workloads, k.exact)
                for n, k in mine.items()} == {
            n: (k.values, k.field, k.env, k.workloads, k.exact)
            for n, k in theirs.items()}
    assert space.SPACE_VERSION == jspace.SPACE_VERSION
    assert space.code_fingerprint() != jspace.code_fingerprint()
    # no default arm of either kind routes a solve off K1
    for kind in ("learn", "solve"):
        for arm in space.default_arms(kind, "solve2d"):
            assert "use_pallas" not in arm


def test_default_arms_apply_cleanly():
    for kind, cfg, workload in (
        ("learn", LearnConfig(), "consensus2d"),
        ("solve", SolveConfig(), "solve2d"),
    ):
        arms = space.default_arms(kind, workload)
        assert {} in arms and len(arms) > 5
        for arm in arms:
            armed, env, dropped = space.apply_arm(cfg, arm, kind, workload)
            assert not dropped
            for name, v in arm.items():
                if space.knobs(kind)[name].field:
                    assert getattr(armed, name) == v
                else:
                    assert env[space.knobs(kind)[name].env] == str(v)


def test_apply_arm_drops_inapplicable_knobs():
    arm = {"fused_z": True, "storage_dtype": "bfloat16"}
    armed, _, dropped = space.apply_arm(LearnConfig(), arm, "learn",
                                        "masked2d")
    assert armed.storage_dtype == "bfloat16"
    assert armed.fused_z is False  # consensus2d-only knob
    assert dropped and dropped[0][0] == "fused_z"
    armed, _, dropped = space.apply_arm(LearnConfig(), {"donate_state": True},
                                        "learn", "streaming2d")
    assert armed.donate_state is False and dropped
    armed, _, dropped = space.apply_arm(SolveConfig(), {"use_pallas": True},
                                        "solve", "solve2d")
    assert armed.use_pallas is False
    assert dropped == [("use_pallas", "not a solve knob")]


def test_dry_run_and_seed_from(capsys):
    """The CLI's dry run validates the space and runs nothing; its
    --seed-from exits 2 (the seeders read the JAX package's rounds)."""
    assert autotune.main(["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "candidate arms" in out and "code fingerprint" in out
    assert autotune.main(["--seed-from", "onchip_r5.jsonl"]) == 2
    with pytest.raises(SystemExit):
        autotune.main([])


# ---------------------------------------------------------------------
# store
# ---------------------------------------------------------------------

def test_store_round_trip_and_ranking(tmp_path):
    path = str(tmp_path / "store.json")
    st = ts.TunedStore(path)
    assert st.empty
    st.add("h100", "learn", "key1", {"fft_impl": "matmul"}, 2.0,
           "outer_iters/sec", source="a")
    st.add("h100", "learn", "key1", {"fused_z": True}, 3.0,
           "outer_iters/sec", source="b")
    st.add("h100", "learn", "key1", {}, 1.0, "outer_iters/sec")
    st.save()
    st2 = ts.TunedStore(path)
    assert [c["value"] for c in st2.candidates("h100", "learn", "key1")] == [
        3.0, 2.0, 1.0]
    st2.demote("h100", "learn", "key1", {"fused_z": True}, reason="x")
    st2.save()
    st3 = ts.TunedStore(path)
    assert [c["value"] for c in st3.candidates("h100", "learn", "key1")] == [
        2.0, 1.0]
    st3.add("h100", "learn", "key1", {"fused_z": True}, 4.0,
            "outer_iters/sec")
    assert st3.candidates("h100", "learn", "key1")[0]["value"] == 4.0


def test_store_refuses_cross_chip_and_stale_fingerprint(tmp_path):
    st = ts.TunedStore(str(tmp_path / "store.json"))
    st.add("v5e", "learn", "key1", {"fft_impl": "matmul"}, 2.0,
           "outer_iters/sec")
    assert st.candidates("h100", "learn", "key1") == []
    assert st.candidates("cpu", "learn", "key1") == []
    assert st.chips_with_entries("learn", "key1") == ["v5e"]
    st._data["v5e|learn|key1"][0]["fp"] = "stale000000"
    assert st.candidates("v5e", "learn", "key1") == []
    assert st.chips_with_entries("learn", "key1") == []
    st._data["v5e|learn|key1"][0]["fp"] = space.code_fingerprint()
    st.demote("v5e", "learn", "key1", {"fft_impl": "matmul"}, "test")
    assert st.chips_with_entries("learn", "key1") == []
    # an entry the JAX package wrote (its fingerprint) never matches
    st.add("h100", "solve", "k", {}, 1.0, "solves/sec")
    st._data["h100|solve|k"][0]["fp"] = jspace.code_fingerprint()
    assert st.candidates("h100", "solve", "k") == []


def test_store_corrupt_file_reads_as_empty(tmp_path):
    path = tmp_path / "store.json"
    path.write_text("{not json")
    st = ts.TunedStore(str(path))
    assert st.empty
    st.add("cpu", "solve", "k", {}, 1.0, "solves/sec")
    st.save()
    assert not ts.TunedStore(str(path)).empty


def test_store_path_order(monkeypatch, tmp_path):
    """CCSC_TUNE_STORE > $CCSC_COMPILE_CACHE/ccsc_tuned_knobs.json > the
    kernel build directory's; never the repo's tuned_knobs.json."""
    from ccsc_code_iccv2017_torch.ops import kernels

    assert ts.default_store_path() == str(tmp_path / "default.json")
    monkeypatch.delenv("CCSC_TUNE_STORE")
    monkeypatch.setenv("CCSC_COMPILE_CACHE", str(tmp_path / "cc"))
    assert ts.default_store_path() == str(tmp_path / "cc" /
                                          "ccsc_tuned_knobs.json")
    monkeypatch.delenv("CCSC_COMPILE_CACHE")
    p = ts.default_store_path()
    assert p == os.path.join(kernels.build_dir(), "ccsc_tuned_knobs.json")
    assert p != os.path.join(REPO, "tuned_knobs.json")


# ---------------------------------------------------------------------
# resolution, the guard, sweeps
# ---------------------------------------------------------------------

def test_resolve_no_entries_keeps_defaults(tmp_path):
    """A miss runs the defaults and says why in its tune_pick record,
    naming the chips that do have entries."""
    st = ts.TunedStore(str(tmp_path / "store.json"))
    events = []
    emit = lambda t, **f: events.append((t, f))
    cfg, picked = autotune.resolve_learn(
        LearnConfig(tune="auto"), GEOM_2D(8, 5), (4, 16, 16), chip="h100",
        store=st, guard=False, emit=emit, device="cpu")
    assert picked is None and cfg.fft_impl == "xla" and cfg.tune == "off"
    assert events[0][0] == "tune_pick" and events[0][1]["arm"] is None
    assert events[0][1]["reason"] == "no tuned entry for this chip/shape"
    key = autotune._learn_key(LearnConfig(), GEOM_2D(8, 5), (4, 16, 16),
                              "consensus2d")
    st.add("v5e", "learn", key, {"fft_impl": "matmul"}, 2.0, "x")
    events.clear()
    cfg, picked = autotune.resolve_learn(
        LearnConfig(tune="auto"), GEOM_2D(8, 5), (4, 16, 16), chip="h100",
        store=st, guard=False, emit=emit, device="cpu")
    assert picked is None and cfg.fft_impl == "xla"
    assert "v5e" in events[0][1]["reason"]


def test_sweep_with_injected_timer_ranks_and_persists(tmp_path):
    st = ts.TunedStore(str(tmp_path / "store.json"))
    speeds = {"baseline": 1.0, "fft_impl=matmul": 3.0,
              "storage_dtype=bfloat16": 2.0, "fft_pad=pow2": 0.5}
    arms = [{}, {"fft_impl": "matmul"}, {"storage_dtype": "bfloat16"},
            {"fft_pad": "pow2"}]
    events = []
    autotune.sweep_learn(
        LearnConfig(num_blocks=2), GEOM_2D(8, 5), (8, 24, 24), chip="cpu",
        store=st, arms=arms,
        timer=lambda armed, arm: speeds[space.arm_label(arm)],
        emit=lambda t, **f: events.append((t, f)), device="cpu")
    key = ts.learn_shape_key("consensus2d", k=8, support=(5, 5), n=8,
                             size=(24, 24), blocks=2)
    st2 = ts.TunedStore(str(tmp_path / "store.json"))
    cands = st2.candidates("cpu", "learn", key)
    assert [c["value"] for c in cands] == [3.0, 2.0, 1.0]
    assert all(c["arm"] != {"fft_pad": "pow2"} for c in cands)
    assert sum(1 for t, _ in events if t == "tune_arm") == 4
    cfg, _ = autotune.resolve_learn(
        LearnConfig(tune="auto", num_blocks=2), GEOM_2D(8, 5), (8, 24, 24),
        chip="cpu", store=st2, guard=False, device="cpu")
    assert cfg.fft_impl == "matmul"


def test_sweep_timer_failure_records_no_entry(tmp_path):
    st = ts.TunedStore(str(tmp_path / "store.json"))

    def timer(armed, arm):
        if arm:
            raise RuntimeError("this device cannot run this knob")
        return 1.0

    autotune.sweep_learn(
        LearnConfig(num_blocks=2), GEOM_2D(8, 5), (8, 24, 24), chip="cpu",
        store=st, arms=[{}, {"fft_impl": "matmul"}], timer=timer,
        emit=lambda t, **f: None, device="cpu")
    key = ts.learn_shape_key("consensus2d", k=8, support=(5, 5), n=8,
                             size=(24, 24), blocks=2)
    assert [c["arm"] for c in st.candidates("cpu", "learn", key)] == [{}]


def test_guard_demotes_poisoned_arm_and_applies_next_best(tmp_path,
                                                         monkeypatch):
    """The real guard on a real numerics difference: bf16 code storage
    moves the tiny guard problem's trajectory by ~1e-4, the float32
    matmul DFT by ~1e-7; a tolerance between them demotes the bf16 arm
    (persisted), applies the matmul arm and caches its verdict."""
    monkeypatch.setenv("CCSC_TUNE_GUARD_TOL", "1e-5")
    path = str(tmp_path / "store.json")
    st = ts.TunedStore(path)
    key = ts.learn_shape_key("consensus2d", k=8, support=(5, 5), n=4,
                             size=(16, 16), blocks=2)
    st.add("cpu", "learn", key, {"storage_dtype": "bfloat16"}, 9.0,
           "outer_iters/sec", source="poisoned")
    st.add("cpu", "learn", key, {"fft_impl": "matmul"}, 5.0,
           "outer_iters/sec", source="survivor")
    st.save()
    events = []
    cfg, picked = autotune.resolve_learn(
        LearnConfig(tune="auto", num_blocks=2), GEOM_2D(8, 5), (4, 16, 16),
        chip="cpu", store=st, emit=lambda t, **f: events.append((t, f)),
        device="cpu")
    assert picked["source"] == "survivor"
    assert cfg.fft_impl == "matmul" and cfg.storage_dtype == "float32"
    assert [f["ok"] for t, f in events if t == "tune_guard"] == [False, True]
    st2 = ts.TunedStore(path)
    assert [c["source"] for c in st2.candidates("cpu", "learn", key)] == [
        "survivor"]

    def no_guard(*a):
        raise AssertionError("the guard must not run again")

    cfg2, picked2 = autotune.resolve_learn(
        LearnConfig(tune="auto", num_blocks=2), GEOM_2D(8, 5), (4, 16, 16),
        chip="cpu", store=st2, emit=lambda t, **f: None, guard=no_guard,
        device="cpu")
    assert picked2 is not None and cfg2.fft_impl == "matmul"


@pytest.mark.parametrize("kind", ["solve", "learn"])
def test_guard_demotes_schur_at_the_w31_gram(tmp_path, kind):
    """A Gram-inverse arm is held at the workload's own Gram sizes and at
    the W=31 hyperspectral Gram's conditioning (autotune.guard_gram):
    the Schur recursion, whose error grows as cond^2, is demoted at
    W=31 although the W=1 trajectory guard cannot see it, and the
    Cholesky arm behind it applies."""
    geom = ProblemGeom((5, 5), 4, reduce_shape=(31,))
    st = ts.TunedStore(str(tmp_path / "store.json"))
    events = []
    emit = lambda t, **f: events.append((t, f))
    if kind == "solve":
        workload = "solve2d+r1"
        key = ts.solve_shape_key(workload, k=4, support=(5, 5),
                                 spatial=(16, 16))
    else:
        workload = "consensus2d+r1"
        key = autotune._learn_key(LearnConfig(num_blocks=2), geom,
                                  (4, 31, 16, 16), workload)
    assert autotune.gram_sizes(kind, geom, (4, 31, 16, 16),
                               LearnConfig(num_blocks=2), workload) == (
        (31,) if kind == "solve" else (2, 31))
    st.add("cpu", kind, key, {"herm_inv": "schur"}, 9.0, "x", source="schur")
    st.add("cpu", kind, key, {"herm_inv": "cholesky"}, 5.0, "x",
           source="cholesky")
    if kind == "solve":
        cfg, picked = autotune.resolve_solve(
            SolveConfig(tune="auto"), geom, (16, 16), workload=workload,
            chip="cpu", store=st, emit=emit, device="cpu")
        assert cfg.herm_inv == "cholesky"
    else:
        cfg, picked = autotune.resolve_learn(
            LearnConfig(tune="auto", num_blocks=2), geom, (4, 31, 16, 16),
            workload=workload, chip="cpu", store=st, emit=emit,
            apply_env=False, device="cpu")
    assert picked["source"] == "cholesky"
    guards = [(f["arm"], f["ok"], f["dev"]) for t, f in events
              if t == "tune_guard"]
    assert [g[:2] for g in guards] == [({"herm_inv": "schur"}, False),
                                       ({"herm_inv": "cholesky"}, True)]
    assert guards[0][2] > 0.1  # cond^2: far past any float32 tolerance
    assert [c["source"] for c in st.candidates("cpu", kind, key)] == [
        "cholesky"]
    # the probe itself: Schur passes where it is exact (m = 2), Cholesky
    # and the guarded Newton pass at W = 31
    assert autotune.guard_gram("schur", (2,), device="cpu")[0]
    assert autotune.guard_gram("newton", (31,), device="cpu")[0]
    assert not autotune.guard_gram("schur", (31,), device="cpu")[0]


def test_sweep_demotes_a_win_inside_the_baselines_spread(tmp_path):
    """Interleaved pairs: an arm persists as a winner only when it wins
    most of its pairs by more than the baseline's own spread."""
    st = ts.TunedStore(str(tmp_path / "store.json"))
    flip = iter([1.0, 2.0] * 100)
    speeds = {"fft_impl=matmul": 1.9, "storage_dtype=bfloat16": 5.0}

    def timer(armed, arm):
        return next(flip) if not arm else speeds[space.arm_label(arm)]

    events = []
    autotune.sweep_solve(
        SolveConfig(), ProblemGeom((5, 5), 4), (16, 16), chip="cpu",
        store=st, arms=[{}, {"fft_impl": "matmul"},
                        {"storage_dtype": "bfloat16"}],
        timer=timer, emit=lambda t, **f: events.append((t, f)), pairs=4,
        device="cpu")
    key = ts.solve_shape_key("solve2d", k=4, support=(5, 5), spatial=(16, 16))
    # the baseline's samples spread 1.0-2.0: 1.9 beats its median but
    # not its spread (100%); 5.0 wins every pair by more than that
    assert [space.arm_label(c["arm"]) for c in
            st.candidates("cpu", "solve", key)] == [
        "storage_dtype=bfloat16", "baseline"]
    pairs = [f["pairs"] for t, f in events
             if t == "tune_arm" and f["arm"] == {"fft_impl": "matmul"}][0]
    assert len(pairs) == 4


def test_injected_guard_flow(tmp_path):
    st = ts.TunedStore(str(tmp_path / "store.json"))
    st.add("cpu", "solve", "key", {"fft_impl": "matmul_bf16"}, 9.0,
           "solves/sec")
    st.add("cpu", "solve", "key", {"fft_impl": "matmul"}, 5.0, "solves/sec")
    calls = []

    def guard(kind, arm, tol):
        calls.append(arm)
        return arm != {"fft_impl": "matmul_bf16"}, 1.0

    cfg, picked, env = autotune._resolve(
        "solve", SolveConfig(), "key", "solve2d", "cpu", st,
        lambda t, **f: None, guard, "cpu")
    assert cfg.fft_impl == "matmul" and len(calls) == 2


def test_all_arms_demoted_falls_back_to_defaults(tmp_path):
    st = ts.TunedStore(str(tmp_path / "store.json"))
    st.add("cpu", "solve", "key", {"fft_impl": "matmul"}, 5.0, "solves/sec")
    events = []
    cfg, picked, _ = autotune._resolve(
        "solve", SolveConfig(), "key", "solve2d", "cpu", st,
        lambda t, **f: events.append((t, f)),
        lambda kind, arm, tol: (False, float("inf")), "cpu")
    assert picked is None and cfg.fft_impl == "xla"
    assert events[-1][0] == "tune_pick"
    assert "demoted" in events[-1][1]["reason"]


def test_cpu_sweep_solve_then_auto_reads_it_back(tmp_path):
    """A real sweep on this device (the CPU) into tmp_path, then
    tune='auto' on the same shape reads the entry back under the 'cpu'
    chip key, and a different chip's key sees none of it."""
    path = str(tmp_path / "store.json")
    geom = ProblemGeom((5, 5), 4)
    cfg = SolveConfig(max_it=3, verbose="none", lambda_prior=0.3)
    arms = [{}, {"fft_impl": "matmul"}, {"herm_inv": "schur"}]
    autotune.sweep_solve(cfg, geom, (16, 16), store=ts.TunedStore(path),
                         arms=arms, emit=lambda t, **f: None, reps=1,
                         device="cpu")
    st = ts.TunedStore(path)
    key = ts.solve_shape_key("solve2d", k=4, support=(5, 5), spatial=(16, 16))
    rows = st._data[f"cpu|solve|{key}"]
    # herm_inv applies to W > 1 workloads only: never timed at solve2d
    assert sorted(space.arm_label(r["arm"]) for r in rows) == [
        "baseline", "fft_impl=matmul"]
    assert all(r["value"] > 0 and r["unit"] == "solves/sec" for r in rows)
    events = []
    got, picked = autotune.resolve_solve(
        dataclasses.replace(cfg, tune="auto"), geom, (16, 16),
        store=st, emit=lambda t, **f: events.append((t, f)), device="cpu")
    assert picked is not None and picked in st.candidates("cpu", "solve", key)
    assert events[-1][1]["chip"] == "cpu"
    assert st.candidates("h100", "solve", key) == []


# ---------------------------------------------------------------------
# the engine, reconstruct and the learner apps
# ---------------------------------------------------------------------

def test_engine_startup_picks_tuned_knobs(tmp_path):
    from ccsc_code_iccv2017_torch.models.reconstruct import (
        ReconstructionProblem)
    from ccsc_code_iccv2017_torch.serve import CodecEngine
    from ccsc_code_iccv2017_torch.utils import obs

    d = _unit_bank()
    geom = ProblemGeom((5, 5), 4)
    spath = str(tmp_path / "store.json")
    st = ts.TunedStore(spath)
    st.add("cpu", "solve",
           ts.solve_shape_key("solve2d", k=4, support=(5, 5),
                              spatial=(24, 24)),
           {"fft_impl": "matmul"}, 9.0, "solves/sec", source="seeded")
    st.save()
    mdir = str(tmp_path / "metrics")
    cfg = SolveConfig(max_it=4, tol=0.0, verbose="none", lambda_prior=0.3)
    scfg = ServeConfig(buckets=((2, (24, 24)),), metrics_dir=mdir,
                       verbose="none", tune="auto", tune_store=spath)
    with CodecEngine(d, ReconstructionProblem(geom), cfg, scfg,
                     device="cpu") as eng:
        assert eng.cfg.fft_impl == "matmul"
        r = np.random.default_rng(1)
        x = r.random((16, 16)).astype(np.float32)
        m = (r.random((16, 16)) < 0.6).astype(np.float32)
        assert int(eng.reconstruct(x * m, mask=m).trace.num_iters) == 4
    events = obs.read_events(mdir)
    picks = [e for e in events if e.get("type") == "tune_pick"]
    assert picks and picks[0]["arm"] == {"fft_impl": "matmul"}
    warmups = [e for e in events if e.get("type") == "serve_warmup"]
    assert warmups
    for w in warmups:
        assert w["knobs"]["fft_impl"] == "matmul"
        assert w["knobs"]["tuned"] is True and w["knobs"]["tune"] == "auto"


def test_engine_tune_off_serving_bit_identity():
    from ccsc_code_iccv2017_torch.models.reconstruct import (
        ReconstructionProblem, reconstruct)
    from ccsc_code_iccv2017_torch.serve import CodecEngine

    d = _unit_bank()
    prob = ReconstructionProblem(ProblemGeom((5, 5), 4))
    cfg = SolveConfig(max_it=5, tol=0.0, verbose="none", lambda_prior=0.3,
                      track_objective=True)
    r = np.random.default_rng(2)
    x = r.random((16, 16)).astype(np.float32)
    m = (r.random((16, 16)) < 0.6).astype(np.float32)
    with CodecEngine(d, prob, cfg, ServeConfig(buckets=((2, (16, 16)),),
                                               verbose="none"),
                     device="cpu") as eng:
        assert eng._knob_dict["tuned"] is False
        served = eng.reconstruct(x * m, mask=m)
    direct = reconstruct((x * m)[None], d, prob, cfg, mask=m[None],
                         device="cpu")
    np.testing.assert_array_equal(served.recon, direct.recon[0].numpy())


def test_reconstruct_inline_tune_auto(tmp_path, monkeypatch):
    """tune='auto' on a direct reconstruct resolves once at the call (a
    plan does not combine with it; build_plan wants a resolved config)."""
    from ccsc_code_iccv2017_torch.models import reconstruct as trec

    d = _unit_bank()
    geom = ProblemGeom((5, 5), 4)
    prob = trec.ReconstructionProblem(geom)
    path = str(tmp_path / "store.json")
    monkeypatch.setenv("CCSC_TUNE_STORE", path)
    monkeypatch.setenv("CCSC_TUNE_GUARD", "0")
    st = ts.TunedStore(path)
    st.add("cpu", "solve",
           ts.solve_shape_key("solve2d", k=4, support=(5, 5),
                              spatial=(16, 16)),
           {"fft_impl": "matmul"}, 9.0, "solves/sec")
    st.save()
    r = np.random.default_rng(3)
    x = r.random((1, 16, 16)).astype(np.float32)
    m = (r.random(x.shape) < 0.6).astype(np.float32)
    base = SolveConfig(max_it=4, tol=0.0, verbose="none", lambda_prior=0.3,
                       track_objective=True)
    tuned = trec.reconstruct(x * m, d, prob,
                             dataclasses.replace(base, tune="auto"), mask=m,
                             device="cpu")
    ref = trec.reconstruct(x * m, d, prob,
                           dataclasses.replace(base, fft_impl="matmul"),
                           mask=m, device="cpu")
    assert torch.equal(tuned.recon, ref.recon)
    plan = trec.build_plan(d, prob, base, (16, 16), device="cpu")
    with pytest.raises(ValueError, match="plan"):
        trec.reconstruct(x * m, d, prob, dataclasses.replace(base,
                                                             tune="auto"),
                         mask=m, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="resolved config"):
        trec.build_plan(d, prob, dataclasses.replace(base, tune="sweep"),
                        (16, 16), device="cpu")


def test_learner_app_resolves_tune_into_its_stream(tmp_path, monkeypatch):
    """--tune auto on a learner CLI: one resolution before the run, its
    tune_pick record in the metrics dir's tune file, the store's arm
    applied (here chunked + donated: exact knobs, no guard)."""
    from ccsc_code_iccv2017_torch.apps import learn_3d
    from ccsc_code_iccv2017_torch.utils import obs

    path = str(tmp_path / "store.json")
    monkeypatch.delenv("CCSC_TUNE_STORE")
    argv = ["--synthetic", "--clips", "4", "--clip-size", "8",
            "--clip-frames", "6", "--filters", "3", "--support", "3",
            "--support-t", "3", "--blocks", "2", "--max-it", "2", "--tol",
            "0", "--device", "cpu", "--verbose", "none"]
    geom = ProblemGeom((3, 3, 3), 3)
    plain = learn_3d.main(argv + ["--out", str(tmp_path / "p.mat")])
    n, *sp = plain.Dz.shape
    key = autotune._learn_key(LearnConfig(num_blocks=2), geom,
                              (n, *sp), "consensus3d")
    st = ts.TunedStore(path)
    st.add("cpu", "learn", key, {"outer_chunk": 4, "donate_state": True},
           5.0, "outer_iters/sec")
    st.save()
    mdir = str(tmp_path / "m")
    res = learn_3d.main(argv + ["--tune", "auto", "--tune-store", path,
                                "--metrics-dir", mdir,
                                "--out", str(tmp_path / "t.mat")])
    picks = [e for e in obs.read_events(mdir) if e["type"] == "tune_pick"]
    assert picks and picks[0]["arm"] == {"outer_chunk": 4,
                                         "donate_state": True}
    assert torch.equal(res.d, plain.d)  # the chunked driver: bitwise
    assert os.environ["CCSC_TUNE_STORE"] == path


def test_jax_configs_classify_the_same_fields():
    """The port's configs carry JAX's fields, so JAX's drift guard and
    the port's classify the same names (use_pallas on different sides)."""
    for kind, tcls, jcls in (("learn", config.LearnConfig,
                              jconfig.LearnConfig),
                             ("solve", config.SolveConfig,
                              jconfig.SolveConfig)):
        names = {f.name for f in dataclasses.fields(tcls)}
        assert names == {f.name for f in dataclasses.fields(jcls)}
        assert set(space.knobs(kind)) | set(space._NON_TUNED[kind]) == \
            set(jspace.knobs(kind)) | set(jspace._NON_TUNED[kind])
