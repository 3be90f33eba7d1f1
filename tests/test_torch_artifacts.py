"""The port's library store (``ccsc_code_iccv2017_torch.serve.artifacts``),
its library fingerprints (``ops.kernels``, ``data.native``) and its
warmup smoke, on the CPU.

- The store's contracts of the JAX ``tests/test_artifacts.py`` (publish
  and fetch, a torn manifest line, concurrent publishers, foreign
  records, a missing or corrupt payload and the repair), each run on the
  port's store and on the JAX ``ArtifactStore`` with the same inputs and
  held to the same statuses (the port's version field is the compiler's
  version line, JAX's the jax release). JAX's serialize cases have no
  counterpart: the port stores built libraries, not executables.
- ``rank_buckets`` gives the JAX function's order on the same declared
  list and on one workload capture written by the port's
  ``serve/capture.py``, and both refuse a typo.
- A library's fingerprint, so its file name and its store key, changes
  with its source, flags, compiler version and chip (for the native
  library, the host CPU); ``kernels.build_all``'s fetch and publish path
  runs against a stand-in nvcc on PATH (nothing is loaded).
- The native library makes a real g++ cold build -> publish -> warm
  fetch in two processes with empty build directories, and the warmup
  smoke (``python -m ccsc_code_iccv2017_torch.serve.warmup_smoke --device
  cpu``) passes.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.serve import artifacts as jarts
from ccsc_code_iccv2017_tpu.utils.validate import CCSCInputError as JInputError
from ccsc_code_iccv2017_torch.data import native
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.serve import artifacts as tarts
from ccsc_code_iccv2017_torch.serve import capture as tcap
from ccsc_code_iccv2017_torch.utils import obs
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "cpu-single-aaaa"
# the version field each store records: the compiler's line for the
# port, the jax release for JAX
VERSION_FIELD = {jarts: "jax", tarts: "toolkit"}
TOOLKIT = "g++ (test) 1.0"


def _blob(seed=0, n=2048):
    return np.random.default_rng(seed).bytes(n)


def _publish(mod, store, key=KEY, payload=None, **kw):
    kw.setdefault("fingerprint", "aaaa")
    kw.setdefault("chip", "cpu")
    if mod is tarts:
        kw.setdefault("toolkit", TOOLKIT)
    return store.publish(key, payload or _blob(), **kw)


def _fetch(mod, store, key=KEY, **kw):
    if mod is tarts and "toolkit" not in kw and kw:
        kw["toolkit"] = TOOLKIT
    return store.fetch(key, **kw)


def _both(tmp_path, scenario):
    """``scenario(mod, store_dir)`` on each package's store; the two
    return values, which the caller holds equal."""
    return [scenario(mod, str(tmp_path / name))
            for mod, name in ((jarts, "jax"), (tarts, "port"))]


def _payload_dir(mod):
    return "programs" if mod is jarts else "libraries"


# -- the store: JAX's contracts, side by side -----------------------------
def test_publish_fetch_roundtrip_like_jax(tmp_path):
    payload = _blob()

    def scenario(mod, path):
        st = mod.ArtifactStore(path)
        rec, status = _publish(mod, st, payload=payload, bucket="2@12x12")
        got, how = _fetch(mod, st, fingerprint="aaaa", chip="cpu")
        keys = st.keys()
        st.close()
        return status, rec["key"], how, got == payload, keys

    j, t = _both(tmp_path, scenario)
    assert t == j == ("won", KEY, "hit", True, [KEY])


def test_torn_manifest_line_reads_as_absent_like_jax(tmp_path):
    """A publisher killed mid-append leaves a torn tail: its record is
    ABSENT, every earlier one survives, and the store writes on."""

    def scenario(mod, path):
        st = mod.ArtifactStore(path)
        _publish(mod, st)
        st.close()
        man = os.path.join(path, "manifest.jsonl")
        with open(man, "rb") as f:
            whole = f.read()
        torn = json.dumps({"key": "cpu-single-bbbb", "sha256": "x" * 64})
        with open(man, "wb") as f:
            f.write(whole + torn[: len(torn) // 2].encode())
        st2 = mod.ArtifactStore(path)
        out = [st2.keys(), st2.resolve("cpu-single-bbbb"),
               st2.fetch("cpu-single-bbbb")[1], st2.fetch(KEY)[1]]
        _publish(mod, st2, key="cpu-single-cccc", fingerprint="cccc")
        st2.close()
        st3 = mod.ArtifactStore(path)
        out.append(st3.fetch("cpu-single-cccc")[1])
        st3.close()
        return out

    j, t = _both(tmp_path, scenario)
    assert t == j == [[KEY], None, "miss", "hit", "hit"]


def test_concurrent_publish_exactly_one_winner_like_jax(tmp_path):
    payload = _blob()

    def scenario(mod, path):
        st = mod.ArtifactStore(path)
        statuses, lock = [], threading.Lock()
        start = threading.Barrier(8)

        def pub():
            start.wait()
            _rec, status = _publish(mod, st, payload=payload)
            with lock:
                statuses.append(status)

        ts = [threading.Thread(target=pub) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert all(s in ("won", "lost", "exists") for s in statuses)
        out = (statuses.count("won"), len(st._read_manifest()),
               st.fetch(KEY)[0] == payload,
               sorted(os.listdir(os.path.join(path, _payload_dir(mod)))))
        st.close()
        return out

    j, t = _both(tmp_path, scenario)
    assert j == (1, 1, True, [f"{KEY}.bin"])
    assert t == (1, 1, True, [f"{KEY}.so"])


def test_foreign_library_refused_like_jax(tmp_path):
    """Another chip, another fingerprint, another compiler (JAX: another
    jax release): each refused, never loaded. A newer record under a
    skewed version shadows the good one and is refused."""

    def scenario(mod, path):
        st = mod.ArtifactStore(path)
        _publish(mod, st)
        out = [_fetch(mod, st, fingerprint="aaaa", chip="tpu-v5e")[1],
               _fetch(mod, st, fingerprint="ffff", chip="cpu")[1]]
        rec = st.resolve(KEY)
        skew = dict(rec, seq=rec["seq"] + 1,
                    **{VERSION_FIELD[mod]: "0.0.0"})
        with open(os.path.join(path, "manifest.jsonl"), "a") as f:
            f.write(json.dumps(skew) + "\n")
        st2 = mod.ArtifactStore(path)
        out.append(_fetch(mod, st2, fingerprint="aaaa", chip="cpu")[1])
        st2.close()
        st.close()
        return out

    j, t = _both(tmp_path, scenario)
    assert t == j == ["chip_mismatch", "fingerprint_mismatch",
                      "version_skew"]


def test_missing_and_corrupt_payload_read_as_absent_like_jax(tmp_path):
    payload = _blob()

    def scenario(mod, path):
        st = mod.ArtifactStore(path)
        _publish(mod, st, payload=payload)
        (name,) = os.listdir(os.path.join(path, _payload_dir(mod)))
        ppath = os.path.join(path, _payload_dir(mod), name)
        with open(ppath, "wb") as f:
            f.write(payload[: len(payload) // 2])
        out = [st.fetch(KEY)[1]]
        os.unlink(ppath)
        out.append(st.fetch(KEY)[1])
        _rec, status = _publish(mod, st, payload=payload)
        out.append(status in ("won", "repair"))
        out.append(st.fetch(KEY) == (payload, "hit"))
        st.close()
        return out

    j, t = _both(tmp_path, scenario)
    assert t == j == ["corrupt", "missing_payload", True, True]


def test_resolve_artifact_dir_and_labels_like_jax(monkeypatch):
    monkeypatch.delenv("CCSC_ARTIFACT_STORE", raising=False)
    for explicit in (None, "", "/s"):
        assert tarts.resolve_artifact_dir(explicit) == \
            jarts.resolve_artifact_dir(explicit)
    monkeypatch.setenv("CCSC_ARTIFACT_STORE", "/env")
    for explicit in (None, "", "/s"):
        assert tarts.resolve_artifact_dir(explicit) == \
            jarts.resolve_artifact_dir(explicit)
    assert tarts.bucket_label(2, (12, 16)) == \
        jarts.bucket_label(2, (12, 16)) == "2@12x16"
    assert tarts.library_key("solve_z_rank1-abc", "NVIDIA H100 PCIe->h100") \
        == "NVIDIA_H100_PCIe-_h100-solve_z_rank1-abc"


# -- rank_buckets -----------------------------------------------------------
TABLE = [(2, (12, 12)), (4, (16, 16)), (2, (24, 24))]


def test_rank_buckets_declared_order_like_jax():
    for declared in (["2@24x24"], ["4@16x16", "2@24x24", "4@16x16"], None):
        assert tarts.rank_buckets(TABLE, declared=declared) == \
            jarts.rank_buckets(TABLE, declared=declared)
    assert tarts.rank_buckets(TABLE, declared=["2@24x24"]) == [
        (2, (24, 24)), (2, (12, 12)), (4, (16, 16))]
    with pytest.raises(CCSCInputError, match="not.*configured"):
        tarts.rank_buckets(TABLE, declared=["2@99x99"])
    with pytest.raises(JInputError, match="not.*configured"):
        jarts.rank_buckets(TABLE, declared=["2@99x99"])


def test_rank_buckets_by_a_port_capture_like_jax(tmp_path):
    """Request frequency from one workload capture written by the
    port's recorder: both packages rank the table hot to cold alike."""
    path = str(tmp_path / "cap")
    rec = tcap.WorkloadRecorder(path)
    x = np.ones((8, 8), np.float32)
    for i, bucket in enumerate(["4@16x16"] * 3 + ["2@24x24"] * 2
                               + ["2@12x12"]):
        rec.record_submit(f"k{i}", None, x * i, bucket=bucket)
    rec.close()
    order = tarts.rank_buckets(TABLE, capture_dir=path)
    assert order == jarts.rank_buckets(TABLE, capture_dir=path) == [
        (4, (16, 16)), (2, (24, 24)), (2, (12, 12))]
    # a declaration still wins over the capture; an empty capture keeps
    # the configured order
    assert tarts.rank_buckets(TABLE, declared=["2@12x12"],
                              capture_dir=path) == TABLE
    empty = str(tmp_path / "none")
    assert tarts.rank_buckets(TABLE, capture_dir=empty) == \
        jarts.rank_buckets(TABLE, capture_dir=empty) == TABLE


# -- the library fingerprints -----------------------------------------------
def _stub_nvcc(tmp_path, release="12.6", name="bin"):
    """A stand-in nvcc on its own directory: ``--version`` prints a
    version line, a build writes the object file and logs the call."""
    d = tmp_path / name
    d.mkdir()
    log = tmp_path / f"{name}-calls.log"
    nvcc = d / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then\n'
        '  echo "nvcc: NVIDIA (R) Cuda compiler driver"\n'
        f'  echo "Cuda compilation tools, release {release}, V{release}.0"\n'
        "  exit 0\nfi\n"
        f'echo build >> "{log}"\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'echo "object of {release}" > "$out"\n')
    nvcc.chmod(0o755)
    return d, log


@pytest.fixture
def stub_toolkit(tmp_path, monkeypatch):
    """nvcc on PATH is the stand-in; no compile cache is latched."""
    d, log = _stub_nvcc(tmp_path)
    monkeypatch.setenv("PATH", f"{d}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "_BUILD_DIR", None)
    return log


def _k1_name():
    return os.path.basename(kernels._lib_path("solve_z_rank1"))


def test_kernel_fingerprint_holds_source_flags_compiler_chip(
        tmp_path, monkeypatch, stub_toolkit):
    fp = kernels.library_fingerprint("solve_z_rank1")
    assert fp["compiler"] == "Cuda compilation tools, release 12.6, V12.6.0"
    assert fp["arch"] == "sm_90a" and fp["chip"] == "cpu"
    assert fp["flags"] == list(kernels.NVCC_FLAGS)
    base = _k1_name()
    assert base.startswith("libsolve_z_rank1_") and base.endswith(".so")
    names = {}
    # the source
    src = tmp_path / "csrc"
    src.mkdir()
    for name, path in kernels.sources().items():
        (src / f"{name}.cu").write_bytes(open(path, "rb").read())
    with open(src / "solve_z_rank1.cu", "a") as f:
        f.write("// edited\n")
    with monkeypatch.context() as m:
        m.setattr(kernels, "CSRC_DIR", str(src))
        names["source"] = _k1_name()
    # the flags
    with monkeypatch.context() as m:
        m.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
        names["flags"] = _k1_name()
    # the compiler's version
    other, _ = _stub_nvcc(tmp_path, release="12.8", name="bin2")
    with monkeypatch.context() as m:
        m.setenv("PATH", f"{other}{os.pathsep}{os.environ['PATH']}")
        names["compiler"] = _k1_name()
    # the chip
    from ccsc_code_iccv2017_torch.utils import perfmodel

    with monkeypatch.context() as m:
        m.setattr(perfmodel, "detect_chip", lambda device=None: "h100")
        names["chip"] = _k1_name()
    assert _k1_name() == base
    assert len(set(names.values()) | {base}) == 5, names


def test_native_fingerprint_holds_source_flags_compiler_cpu(
        tmp_path, monkeypatch):
    fp = native.library_fingerprint()
    assert fp["compiler"].startswith(("g++", "c++"))
    assert fp["chip"] == native.cpu_identity()
    base = os.path.basename(native.lib_path())
    names = {}
    src = tmp_path / "ccsc_data.cpp"
    src.write_bytes(open(native.SOURCE, "rb").read() + b"// edited\n")
    with monkeypatch.context() as m:
        m.setattr(native, "SOURCE", str(src))
        names["source"] = os.path.basename(native.lib_path())
    with monkeypatch.context() as m:
        m.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
        names["flags"] = os.path.basename(native.lib_path())
    with monkeypatch.context() as m:
        m.setattr(native, "_compiler", lambda cxx: "g++ (other) 99.0")
        names["compiler"] = os.path.basename(native.lib_path())
    with monkeypatch.context() as m:
        m.setattr(native, "cpu_identity", lambda cxx=None: "x86_64-other")
        names["cpu"] = os.path.basename(native.lib_path())
    assert os.path.basename(native.lib_path()) == base
    assert len(set(names.values()) | {base}) == 5, names


def _build_into(store, bdir, monkeypatch):
    """``build_all`` of K1 through ``store`` into the build directory
    ``bdir`` (a fresh host's)."""
    monkeypatch.setattr(kernels, "_BUILD_DIR", str(bdir))
    return kernels.build_all(["solve_z_rank1"], store=store)["solve_z_rank1"]


def test_build_all_fetch_and_publish_with_a_stub_nvcc(tmp_path, monkeypatch,
                                                      stub_toolkit):
    """Cold: nvcc runs, the library is published (won). Warm, into an
    empty build directory: fetched (hit), the same bytes, no nvcc call.
    Present: a cache-hit with no fetch. A corrupt payload: refused,
    rebuilt and re-published (repair). Another chip: another key, so a
    miss and a build. Nothing is loaded."""
    log = stub_toolkit
    mdir = str(tmp_path / "m")
    run = obs.start_run(mdir, algorithm="unit", verbose="none", device="cpu")
    st = tarts.ArtifactStore(str(tmp_path / "store"))
    try:
        cold = _build_into(st, tmp_path / "a", monkeypatch)
        assert (cold["source"], cold["fetch_status"],
                cold["publish_status"]) == ("compiled", "miss", "won")
        warm = _build_into(st, tmp_path / "b", monkeypatch)
        assert (warm["source"], warm["fetch_status"],
                warm["publish_status"], warm["compiled"]) == (
            "fetched", "hit", None, False)
        assert open(warm["path"], "rb").read() == \
            open(cold["path"], "rb").read()
        again = _build_into(st, tmp_path / "b", monkeypatch)
        assert (again["source"], again["fetch_status"]) == ("cache-hit", None)
        (key,) = st.keys()
        assert key == warm["key"] and key.startswith("cpu-solve_z_rank1-")
        with open(os.path.join(st.path, st.resolve(key)["path"]), "wb") as f:
            f.write(b"torn")
        fixed = _build_into(st, tmp_path / "c", monkeypatch)
        assert (fixed["source"], fixed["fetch_status"],
                fixed["publish_status"]) == ("compiled", "corrupt", "repair")
        assert st.fetch(key)[1] == "hit"
        from ccsc_code_iccv2017_torch.utils import perfmodel

        monkeypatch.setattr(perfmodel, "detect_chip",
                            lambda device=None: "h100")
        other = _build_into(st, tmp_path / "d", monkeypatch)
        assert (other["source"], other["fetch_status"]) == ("compiled",
                                                            "miss")
        assert other["key"] != key
    finally:
        st.close()
        run.close()
    assert open(log).read().count("build") == 3
    kinds = [(c["kind"], c["fun_name"]) for c in obs.read_events(mdir)
             if c["type"] == "compile"]
    assert kinds == [("build", "solve_z_rank1"), ("fetch", "solve_z_rank1"),
                     ("build", "solve_z_rank1"), ("build", "solve_z_rank1")]


# -- the native library through a store, in two processes --------------------
_NATIVE_CHILD = """
import json, sys
import numpy as np
from ccsc_code_iccv2017_torch.data import native
from ccsc_code_iccv2017_torch.serve.artifacts import ArtifactStore
from ccsc_code_iccv2017_torch.utils import obs

build_dir, store_dir, mdir, out = sys.argv[1:5]
native.set_build_dir(build_dir)
run = obs.start_run(mdir, algorithm="unit", verbose="none", device="cpu")
st = ArtifactStore(store_dir)
lib, info = native.load(store=st)
st.close()
r = np.random.default_rng(0)
x = r.random((2, 20, 20)).astype(np.float32)
m = (r.random(x.shape) < 0.5).astype(np.float32)
fill = native.smooth_fill_batch(x * m, m)
run.close()
json.dump({"source": info["source"], "fetch": info["fetch_status"],
           "publish": info["publish_status"], "path": info["path"],
           "fill": fill.tolist()}, open(out, "w"))
"""


def test_native_library_cold_build_publish_warm_fetch(tmp_path):
    """g++ builds the library in a cold process with an empty build
    directory and publishes it; a warm process with another empty
    build directory fetches it (hit) and counts zero ``build``
    records; both compute the same smooth fill."""
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CCSC_COMPILE_CACHE", None)
    got = {}
    for tag in ("cold", "warm"):
        out = str(tmp_path / f"{tag}.json")
        p = subprocess.run(
            [sys.executable, "-c", _NATIVE_CHILD, str(tmp_path / tag),
             store, str(tmp_path / f"m-{tag}"), out],
            capture_output=True, text=True, env=env, timeout=240)
        assert p.returncode == 0, p.stdout + p.stderr
        got[tag] = json.load(open(out))
        got[tag]["compile"] = [
            (c["kind"], c["fun_name"]) for c in
            obs.read_events(str(tmp_path / f"m-{tag}"))
            if c["type"] == "compile"]
    cold, warm = got["cold"], got["warm"]
    assert (cold["source"], cold["fetch"], cold["publish"]) == (
        "compiled", "miss", "won")
    assert (warm["source"], warm["fetch"], warm["publish"]) == (
        "fetched", "hit", None)
    assert cold["compile"] == [("build", "ccsc_data"), ("load", "ccsc_data")]
    assert warm["compile"] == [("fetch", "ccsc_data"), ("load", "ccsc_data")]
    assert os.path.dirname(warm["path"]) == str(tmp_path / "warm")
    assert os.path.basename(warm["path"]) == os.path.basename(cold["path"])
    assert warm["fill"] == cold["fill"]
    (key,) = tarts.ArtifactStore(store).keys()
    assert key.startswith(native.cpu_identity() + "-ccsc_data-")


def test_warmup_smoke_passes_on_the_cpu(tmp_path):
    """``python -m ccsc_code_iccv2017_torch.serve.warmup_smoke --device
    cpu``: every check of the cold and the warm engine startup holds."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "smoke.json")
    p = subprocess.run(
        [sys.executable, "-m", "ccsc_code_iccv2017_torch.serve.warmup_smoke",
         "--device", "cpu", "--json", out],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr
    res = json.load(open(out))
    assert res["ok"] and len(res["checks"]) == 7
    assert res["warm"]["builds"] == [] and res["warm"]["fetch_status"] == [
        "hit"]
    assert res["cold"]["digests"] == res["warm"]["digests"]
