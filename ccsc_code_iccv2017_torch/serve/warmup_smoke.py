"""Warmup smoke: a cold and a warm engine startup against one library
store, end to end, in one process tree (the port of the JAX package's
``scripts/warmup_smoke.py``) — the proof that the library store
(serve.artifacts) really skips the build, not only that the store
round-trips bytes.

Two child engine startups run against the SAME store directory, each
with its own empty compile cache (``ServeConfig.compile_cache``):

  cold   fresh store: the library is built (nvcc on the card, g++ on the
         CPU) and published (``artifact_publish`` won)
  warm   a NEW process on the now-populated store: the library is
         fetched (``hit``) and the process's stream carries ZERO
         ``compile`` records of kind ``build`` — read from the records,
         not from wall-clock deltas, so a fast machine cannot fake it

On the card the library is K1's (``csrc/solve_z_rank1.cu``), which the
engine's warmup fetches or builds; on the CPU the engine loads no
library, so each child resolves the native preprocessing library
(``native/ccsc_data.cpp``, ``data.native.load``) through the store and
makes its requests' smooth fill with it. Both children serve the same
requests and their results must be equal (sha256 of each
reconstruction); both append a ``kind=warmup`` perf-ledger record (to a
scratch ledger), the warm one with ``n_compiles=0`` on the card. With
``--repair`` a third child starts after the store's payload was
corrupted on disk: its fetch reads ``corrupt``, it rebuilds and
re-publishes (``repair``), and the store then fetches clean again.

Usage:
    python -m ccsc_code_iccv2017_torch.serve.warmup_smoke [--device cpu]
        [--repair] [--json PATH]

Exit 0 iff every check holds. ``--device`` defaults to the card (cuda);
``--device cpu`` runs here with g++. :func:`run` is the same smoke as a
function (``chip_smoke.py`` phase 21 drives it with the serving engine of
its phase 10: ``--bank``, ``--bucket``, its requests and ``--cfg``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

PACKAGE = __package__.rsplit(".", 1)[0]  # ccsc_code_iccv2017_torch
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the default problem: the JAX smoke's (k=4 3x3, two tiny buckets)
DEFAULT_CFG = dict(lambda_residual=5.0, lambda_prior=0.3, max_it=3,
                   tol=0.0, verbose="none", track_psnr=True,
                   track_objective=True)
DEFAULT_BUCKETS = ((2, (12, 12)), (2, (16, 16)))


def _default_bank():
    import numpy as np

    r = np.random.default_rng(0)
    d = r.normal(size=(4, 3, 3)).astype(np.float32)
    return d / np.sqrt((d ** 2).sum(axis=(1, 2), keepdims=True))


def _default_requests(seed: int = 0) -> List[Dict[str, Any]]:
    import numpy as np

    r = np.random.default_rng(seed)
    x = r.random((12, 12)).astype(np.float32)
    m = (r.random((12, 12)) < 0.5).astype(np.float32)
    return [{"b": x * m, "mask": m, "x_orig": x}]


# -- the child: one engine startup ----------------------------------------
def _k1_check(slots: int, k: int, spatial: Sequence[int],
              psf_radius: Sequence[int]) -> Dict[str, Any]:
    """K1, launched from the library this process loaded, against its
    plain version at a dispatch's shape (N = the bucket's slots, F its
    padded rfft bins): the error relative to max|z|, two launches' bits,
    and both times (CUDA events). Raises past 1e-5 or on unequal bits."""
    import torch

    from ..ops import kernels
    from ..utils.device import device_time_ms

    padded = [s + 2 * r for s, r in zip(spatial, psf_radius)]
    f = 1
    for s in padded[:-1]:
        f *= s
    f *= padded[-1] // 2 + 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    rho = 100.0
    args = (cplx(k, f), cplx(slots, f), cplx(slots, k, f), rho,
            torch.full((k, f), 1.0 / rho, device=dev))
    z = kernels.solve_z_rank1(*args)
    z2 = kernels.solve_z_rank1(*args)
    torch.cuda.synchronize()
    ref = kernels.solve_z_rank1_reference(*args)
    abs_err = float((z - ref).abs().max())
    out = {"n": slots, "k": k, "f": f, "max_abs_err": abs_err,
           "max_rel_err": abs_err / float(ref.abs().max()),
           "bitwise_repeatable": bool(torch.equal(z, z2)),
           "bytes": (k * (12 + 16 * slots) + 8 * slots) * f,
           "ops": slots * f * (35 * k + 4)}
    out["kernel_ms"] = device_time_ms(lambda: kernels.solve_z_rank1(*args))
    out["plain_ms"] = device_time_ms(
        lambda: kernels.solve_z_rank1_reference(*args), warmup=1, reps=10)
    if not (out["max_rel_err"] <= 1e-5 and out["bitwise_repeatable"]):
        raise RuntimeError(f"K1 from the loaded library disagrees with its "
                           f"plain version or with itself: {out}")
    return out


def child(args) -> int:
    """One engine startup: engine (compile cache and store armed), on
    the CPU the native library through the store, then every request
    served; the report goes to ``args.report`` as JSON."""
    import numpy as np

    from ..config import ProblemGeom, ServeConfig, SolveConfig
    from ..data import native
    from ..models.reconstruct import ReconstructionProblem
    from ..ops import kernels
    from ..utils.io_mat import load_filters_2d
    from . import CodecEngine
    from .artifacts import ArtifactStore
    from .capture import payload_sha

    d = load_filters_2d(args.bank) if args.bank else _default_bank()
    buckets = (tuple(_parse_bucket(b) for b in args.bucket) if args.bucket
               else DEFAULT_BUCKETS)
    cfg = SolveConfig(**(json.loads(args.cfg) if args.cfg
                         else DEFAULT_CFG))
    reqs = []
    with np.load(args.requests) as z:
        for i in range(int(z["n"])):
            reqs.append({k: z[f"{k}{i}"] for k in (
                "b", "mask", "x_orig", "smooth_init") if f"{k}{i}" in z})
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    eng = CodecEngine(
        d, ReconstructionProblem(geom), cfg,
        ServeConfig(buckets=buckets, compile_cache=args.cache,
                    artifact_store=args.store, metrics_dir=args.metrics_dir,
                    verbose="none"),
        device=args.device,
    )
    report: Dict[str, Any] = {"device": args.device}
    try:
        if args.device == "cpu":
            # the engine loads no library on the CPU: the native one
            # goes through the store, and makes the smooth fills
            store = ArtifactStore(args.store)
            _lib, info = native.load(store=store)
            store.close()
            report["native"] = {k: info.get(k) for k in (
                "source", "fetch_status", "fetch_s", "compile_s",
                "publish_status", "key")}
            for q in reqs:
                q["smooth_init"] = native.smooth_fill_batch(
                    q["b"][None], q["mask"][None])[0]
        # join-to-first-request: from the parent's spawn of this process
        report["startup_s"] = time.time() - float(args.t_spawn)
        kernels.solve_z_rank1.launches = 0
        futs = [eng.submit(**q) for q in reqs]
        served = [f.result(timeout=600) for f in futs]
        report["k1_launches"] = kernels.solve_z_rank1.launches
        report["dispatch_iters"] = eng.dispatch_iters
    finally:
        eng.close()
    report["digests"] = [payload_sha(np.ascontiguousarray(r.recon))
                         for r in served]
    report["psnr"] = [r.psnr for r in served]
    report["finite"] = all(bool(np.isfinite(r.recon).all()) for r in served)
    if args.k1_check:
        report["k1_check"] = _k1_check(buckets[0][0], d.shape[0],
                                       buckets[0][1], geom.psf_radius)
    tmp = args.report + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f)
    os.replace(tmp, args.report)
    return 0


def _parse_bucket(spec: str):
    """``SIDE[:SLOTS]`` (the serve app's grammar) -> (slots, (S, S))."""
    side, _, slots = spec.partition(":")
    return int(slots or 1), (int(side), int(side))


# -- the parent: two (or three) children and the checks -------------------
def _write_requests(path: str, requests) -> None:
    import numpy as np

    arrays = {"n": np.int64(len(requests))}
    for i, q in enumerate(requests):
        for k in ("b", "mask", "x_orig", "smooth_init"):
            if q.get(k) is not None:
                arrays[f"{k}{i}"] = np.asarray(q[k], np.float32)
    np.savez(path, **arrays)


def _run_child(tag: str, root: str, store: str, device: str, env,
               extra: Sequence[str], timeout: float) -> Dict[str, Any]:
    """Start one child, wait for it, and return its report, its stream
    (``events``), its wall seconds and its exit code."""
    from ..utils import obs

    mdir = os.path.join(root, f"m-{tag}")
    report = os.path.join(root, f"report-{tag}.json")
    cmd = [sys.executable, "-m", f"{PACKAGE}.serve.warmup_smoke", "--child",
           "--device", device, "--store", store,
           "--cache", os.path.join(root, f"cache-{tag}"),
           "--metrics-dir", mdir, "--report", report,
           "--requests", os.path.join(root, "requests.npz"),
           "--t-spawn", repr(time.time()), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} child failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(report) as f:
        out = json.load(f)
    out["wall_s"] = wall
    out["events"] = obs.read_events(mdir, recursive=True)
    return out


def _summary(rep: Dict[str, Any], device: str) -> Dict[str, Any]:
    """A child's numbers: join-to-first-request, the build and fetch
    records, the store's statuses and the stages' sources."""
    ev = rep["events"]
    comp = [e for e in ev if e["type"] == "compile"]
    ready = [e for e in ev if e["type"] == "serve_ready"]
    out = {
        "startup_s": rep["startup_s"], "wall_s": rep["wall_s"],
        "first_ready_s": ready[0]["first_ready_s"] if ready else None,
        "warmup_s": ready[0]["warmup_s"] if ready else None,
        "n_fetched": ready[0].get("n_fetched") if ready else None,
        "n_compiled": ready[0].get("n_compiled") if ready else None,
        "builds": [(e["fun_name"], e["duration_s"]) for e in comp
                   if e["kind"] == "build"],
        "fetches": [(e["fun_name"], e["duration_s"]) for e in comp
                    if e["kind"] == "fetch"],
        "loads": [(e["fun_name"], e["duration_s"]) for e in comp
                  if e["kind"] == "load"],
        "sources": [e["source"] for e in ev if e["type"] == "serve_warmup"],
        "digests": rep["digests"], "psnr": rep["psnr"],
        "k1_launches": rep["k1_launches"],
        "dispatch_iters": rep["dispatch_iters"],
    }
    if device == "cpu":
        nat = rep["native"]
        out["fetch_status"] = [nat["fetch_status"]]
        out["publish_status"] = [nat["publish_status"]]
        out["library_source"] = nat["source"]
    else:
        out["fetch_status"] = [e["status"] for e in ev
                               if e["type"] == "artifact_fetch"]
        out["publish_status"] = [e["status"] for e in ev
                                 if e["type"] == "artifact_publish"]
        out["library_source"] = out["sources"][0] if out["sources"] else None
    out["build_s"] = sum(s for _, s in out["builds"])
    out["fetch_s"] = sum(s for _, s in out["fetches"])
    if "k1_check" in rep:
        out["k1_check"] = rep["k1_check"]
    return out


def run(device: str = "cuda", bank: Optional[str] = None,
        buckets: Optional[Sequence[str]] = None, requests=None,
        cfg: Optional[Dict[str, Any]] = None, k1_check: bool = False,
        repair: bool = False, root: Optional[str] = None,
        timeout: float = 600.0) -> Dict[str, Any]:
    """The smoke as a function: ``buckets`` as ``SIDE:SLOTS`` specs,
    ``requests`` as dicts of b, mask, x_orig (and smooth_init), ``cfg``
    the SolveConfig's fields. Returns ``{"cold", "warm"[, "repair"],
    "checks", "ok"}``: each child's :func:`_summary` and the list of
    ``(check, passed, detail)``."""
    own_root = root is None
    root = tempfile.mkdtemp(prefix="ccsc-warmup-") if own_root else root
    store = os.path.join(root, "store")
    ledger = os.path.join(root, "ledger.jsonl")
    env = dict(os.environ, CCSC_PERF_LEDGER=ledger)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # an ambient cache or store would let a child skip the build the
    # smoke is about
    for k in ("CCSC_COMPILE_CACHE", "CCSC_ARTIFACT_STORE",
              "CCSC_ARTIFACT_PUBLISH"):
        env.pop(k, None)
    _write_requests(os.path.join(root, "requests.npz"),
                    requests if requests is not None
                    else _default_requests())
    extra: List[str] = []
    if bank:
        extra += ["--bank", bank]
    for b in buckets or ():
        extra += ["--bucket", b]
    if cfg is not None:
        extra += ["--cfg", json.dumps(cfg)]
    out: Dict[str, Any] = {"root": root}
    checks: List = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), str(detail)))

    cold = _summary(_run_child("cold", root, store, device, env, extra,
                               timeout), device)
    warm = _summary(_run_child("warm", root, store, device, env,
                               extra + (["--k1-check"] if k1_check else []),
                               timeout), device)
    out.update(cold=cold, warm=warm)
    check("cold run builds the library", len(cold["builds"]) >= 1,
          f"builds={cold['builds']}")
    check("cold run publishes it",
          any(s in ("won", "repair") for s in cold["publish_status"]),
          f"publish={cold['publish_status']}")
    check("warm run builds NOTHING (zero compile records of kind build)",
          not warm["builds"], f"builds={warm['builds']}")
    check("warm run fetches the library from the store",
          warm["fetch_status"] == ["hit"] and len(warm["fetches"]) == 1,
          f"fetch={warm['fetch_status']}")
    check("warm run's library source is 'fetched'",
          warm["library_source"] == "fetched",
          f"source={warm['library_source']}")
    if device != "cpu":
        check("warm serve_ready reports n_compiled=0 and n_fetched=1",
              (warm["n_compiled"], warm["n_fetched"]) == (0, 1),
              f"(n_compiled, n_fetched)=({warm['n_compiled']}, "
              f"{warm['n_fetched']})")
    check("both runs serve equal results (sha256)",
          cold["digests"] == warm["digests"] and warm["digests"],
          f"{len(warm['digests'])} results")
    recs = []
    if os.path.exists(ledger):
        with open(ledger) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    wrecs = [r for r in recs if r.get("kind") == "warmup"]
    check("both startups append kind=warmup ledger records",
          len(wrecs) == 2, f"warmup_records={len(wrecs)}")
    if device != "cpu":
        check("warm ledger record carries n_compiles=0",
              len(wrecs) == 2 and wrecs[-1].get("n_compiles") == 0,
              f"n_compiles={[r.get('n_compiles') for r in wrecs]}")
    if repair:
        out["repair"] = _repair(root, store, device, env, extra, timeout,
                                cold["digests"], check)
    out["checks"] = checks
    out["ok"] = all(ok for _, ok, _ in checks)
    if own_root and out["ok"]:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return out


def _repair(root, store, device, env, extra, timeout, digests, check):
    """Corrupt the stored payload on disk, start a third child: it reads
    ``corrupt``, rebuilds and re-publishes (``repair``); the store then
    fetches clean."""
    from .artifacts import ArtifactStore

    st = ArtifactStore(store)
    (key,) = st.keys()
    rec = st.resolve(key)
    path = os.path.join(store, rec["path"])
    with open(path, "r+b") as f:
        f.truncate(rec["size"] // 2)
    fixed = _summary(_run_child("repair", root, store, device, env, extra,
                                timeout), device)
    check("a corrupt payload reads as 'corrupt'",
          fixed["fetch_status"] == ["corrupt"],
          f"fetch={fixed['fetch_status']}")
    check("the child rebuilds it and re-publishes ('repair')",
          len(fixed["builds"]) >= 1 and fixed["publish_status"]
          == ["repair"], f"builds={fixed['builds']} "
          f"publish={fixed['publish_status']}")
    blob, status = st.fetch(key, fingerprint=rec["fingerprint"],
                            chip=rec["chip"], toolkit=rec["toolkit"])
    st.close()
    check("the store heals: the next fetch is a hit", status == "hit",
          f"status={status}")
    check("the repaired run serves the same results",
          fixed["digests"] == digests)
    return fixed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the children's engines run (default the "
                        "card, whose library is K1's; cpu: the native "
                        "library, built with g++)")
    p.add_argument("--bank", default=None,
                   help="filter bank .mat (default: a k=4 3x3 random bank)")
    p.add_argument("--bucket", action="append", default=None,
                   metavar="SIDE:SLOTS",
                   help="a serving bucket (repeatable; default the JAX "
                        "smoke's 12:2 and 16:2)")
    p.add_argument("--cfg", default=None,
                   help="SolveConfig fields as JSON (default: the JAX "
                        "smoke's)")
    p.add_argument("--repair", action="store_true",
                   help="also corrupt the stored payload and prove that a "
                        "third startup rebuilds and re-publishes it")
    p.add_argument("--json", default=None,
                   help="write the children's numbers and the checks here")
    # the child's own arguments
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    for name in ("--store", "--cache", "--metrics-dir", "--report",
                 "--requests", "--t-spawn"):
        p.add_argument(name, default=None, help=argparse.SUPPRESS)
    p.add_argument("--k1-check", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args)
    out = run(device=args.device, bank=args.bank, buckets=args.bucket,
              cfg=json.loads(args.cfg) if args.cfg else None,
              repair=args.repair)
    for name, ok, detail in out["checks"]:
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f": {detail}" if detail else ""))
    cold, warm = out["cold"], out["warm"]
    print(f"cold startup {cold['startup_s']:.2f}s (build "
          f"{cold['build_s']:.2f}s) -> warm startup {warm['startup_s']:.2f}s "
          f"(fetch {warm['fetch_s']:.4f}s)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({k: v for k, v in out.items()}, f, indent=1,
                      default=str)
    n_fail = sum(1 for _, ok, _ in out["checks"] if not ok)
    print(f"{len(out['checks']) - n_fail}/{len(out['checks'])} warmup "
          "checks passed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
