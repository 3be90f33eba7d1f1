"""The autotune resolver, numerics guard and sweep (the port of
``ccsc_code_iccv2017_tpu.tune.autotune``), and its CLI.

``tune="auto"`` (LearnConfig / SolveConfig / ServeConfig): at startup,
look up the ranked measured arms for (this card, this workload's shape
bucket) in the tuned store (tune.store) and apply the fastest, behind a
**numerics guard**: before an arm first configures a run on this chip, a
short trajectory-parity check against the all-defaults float32 run must
pass within ``CCSC_TUNE_GUARD_TOL``, and an arm that selects a
Gram-inverse method must also invert Grams of the workload's own sizes
at the W=31 hyperspectral Gram's conditioning (:func:`guard_gram`),
which the tiny trajectory problems never reach. A failing arm is
**demoted** in the store (persisted) and the next-best is tried;
verdicts are cached in the store. A miss runs the defaults and emits ``tune_pick`` with
``arm=None`` and its reason, naming the chips that do have entries.

``tune="sweep"``: time the candidate arms (space.default_arms) on this
device at this shape bucket, each in interleaved pairs against the
baseline; an arm persists as a winner only when it wins most of its
pairs by more than the baseline's own spread. Then resolve as above.
On the card a sample is timed with CUDA events (utils.device.
device_time_ms); on the CPU with the host clock. The timer is injectable
for tests.

``tune="off"`` (the default): nothing here runs.

No arm can put a kernel's plain version on a card's main path: the
port's knob space has no such knob (tune.space: ``use_pallas`` is not
tuned), and an arm that fails to run records nothing and so never wins.

CLI (the flags and exit codes of the JAX package's
``scripts/autotune.py``)::

    python -m ccsc_code_iccv2017_torch.tune.autotune --dry-run
    python -m ccsc_code_iccv2017_torch.tune.autotune --list [--store P]
    python -m ccsc_code_iccv2017_torch.tune.autotune --sweep solve \\
        --size 64 --k 16 --support 7 [--device cpu] [--store P]

``--seed-from`` exits 2: the seeders that read the JAX package's bench
rounds are not ported (ROADMAP.md item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

from . import space, store as store_mod


def chip_now(device=None) -> str:
    """The chip identity of every store key: ``CCSC_TUNE_CHIP`` >
    ``utils.perfmodel.detect_chip(device)`` ('h100' on an H100 HBM3,
    'cpu' on the CPU)."""
    from ..utils import env as _env

    override = _env.env_str("CCSC_TUNE_CHIP")
    if override:
        return override
    from ..utils import perfmodel

    return perfmodel.detect_chip(device)


def guard_tol() -> float:
    """Numerics-guard tolerance: the max relative deviation of an arm's
    objective trajectory from the float32 defaults'."""
    from ..utils import env as _env

    return _env.env_float("CCSC_TUNE_GUARD_TOL")


def _guard_enabled() -> bool:
    from ..utils import env as _env

    return _env.env_flag("CCSC_TUNE_GUARD")


def _default_emit(type_: str, **fields) -> None:
    from ..utils import obs

    run = obs.current_run()
    if run is not None:
        run.event(type_, **fields)


def _console(msg: str) -> None:
    print(msg, flush=True)


class _env_applied:
    """Set an arm's env knobs for the duration of a block."""

    def __init__(self, env: Dict[str, str]):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------
# numerics guard: short trajectory parity against the f32 defaults
# ---------------------------------------------------------------------

def _trajectory_dev(ref, got) -> float:
    import numpy as np

    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    n = min(ref.shape[0], got.shape[0])
    if n == 0:
        return float("inf")
    ref, got = ref[:n], got[:n]
    if not (np.all(np.isfinite(ref)) and np.all(np.isfinite(got))):
        return float("inf")
    scale = np.maximum(np.abs(ref), 1e-12)
    return float(np.max(np.abs(got - ref) / scale))


def guard_learn(arm: Dict[str, object], tol: Optional[float] = None,
                workload: str = "consensus2d",
                device="cuda") -> Tuple[bool, float]:
    """Trajectory parity of a learner arm: a tiny synthetic consensus (or
    masked) learn on ``device``, arm vs defaults, same data and init;
    pass iff both objective series agree to ``tol`` and stay finite. A
    numerics proxy, not a speed probe: it catches an arm whose reduced
    precision diverges on this device before it configures a long
    run."""
    import numpy as np
    import torch

    from ..config import LearnConfig, ProblemGeom

    tol = guard_tol() if tol is None else tol
    masked = workload.startswith("masked")
    geom = ProblemGeom((5, 5), 4)
    base = LearnConfig(
        max_it=3, max_it_d=2, max_it_z=3, num_blocks=1 if masked else 2,
        tol=0.0, verbose="none", track_objective=True, rho_d=50.0,
        rho_z=1.0,
    )
    armed, env_updates, _ = space.apply_arm(base, arm, "learn", workload)
    b = np.random.default_rng(7).normal(size=(4, 16, 16)).astype(np.float32)

    def run(cfg, env):
        gen = torch.Generator(device=device).manual_seed(3)
        with _env_applied(env):
            if masked:
                from ..models.learn_masked import learn_masked

                res = learn_masked(b, geom, cfg, generator=gen, device=device)
            else:
                from ..parallel.consensus import learn

                res = learn(b, geom, cfg, generator=gen, device=device)
        return list(res.trace["obj_vals_d"]) + list(res.trace["obj_vals_z"])

    try:
        ref = run(base, {})
        got = run(armed, env_updates)
    except Exception:
        return False, float("inf")  # an arm that crashes is demoted
    dev = _trajectory_dev(ref, got)
    return dev <= tol, dev


def guard_solve(arm: Dict[str, object], tol: Optional[float] = None,
                workload: str = "solve2d",
                device="cuda") -> Tuple[bool, float]:
    """Trajectory parity of a reconstruction arm: a tiny masked inpainting
    solve on ``device``, arm vs defaults, on the objective trajectory and
    the reconstruction itself."""
    import numpy as np

    from ..config import ProblemGeom, SolveConfig
    from ..models.reconstruct import ReconstructionProblem, reconstruct

    tol = guard_tol() if tol is None else tol
    r = np.random.default_rng(11)
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    prob = ReconstructionProblem(ProblemGeom((5, 5), 4))
    base = SolveConfig(max_it=5, tol=0.0, verbose="none",
                       track_objective=True, lambda_prior=0.3)
    armed, env_updates, _ = space.apply_arm(base, arm, "solve", workload)
    x = r.random((4, 16, 16)).astype(np.float32)
    m = (r.random((4, 16, 16)) < 0.6).astype(np.float32)
    try:
        ref = reconstruct(x * m, d, prob, base, mask=m, device=device)
        with _env_applied(env_updates):
            got = reconstruct(x * m, d, prob, armed, mask=m, device=device)
    except Exception:
        return False, float("inf")
    dev = _trajectory_dev(ref.trace.obj_vals.cpu().numpy(),
                          got.trace.obj_vals.cpu().numpy())
    rec_ref = ref.recon.cpu().numpy()
    rec_got = got.recon.cpu().numpy()
    if not np.all(np.isfinite(rec_got)):
        return False, float("inf")
    scale = max(float(np.abs(rec_ref).max()), 1e-9)
    dev = max(dev, float(np.abs(rec_got - rec_ref).max()) / scale)
    return dev <= tol, dev


# The condition number of the Gram that guard_gram inverts. The W=31
# hyperspectral z-kernel Gram (the k=100 11x11x31 bank at 128^2, rho_z=1)
# reaches ~1e4 on an H100 (chip_smoke.py phase 22 (a)); the trajectory
# guards' tiny problems stay far below it, so only this probe can see a
# method whose error grows as cond^2 (the Schur recursion's explicit
# block inverses, 76.8x relative error on that Gram).
GUARD_GRAM_COND = 1e4


def guard_gram(method: str, sizes, tol: Optional[float] = None,
               device="cuda", cond: float = GUARD_GRAM_COND,
               batch: int = 8) -> Tuple[bool, float]:
    """The Gram-inverse arm on the workload's own Gram sizes: ``batch``
    Hermitian PD complex64 matrices of each size m in ``sizes``, their
    eigenvalues spread from 1 to ``cond``, inverted by ``method`` and by
    the default (the Cholesky); pass iff the largest deviation, relative
    to the largest entry of the default's inverse, is within ``tol``."""
    import numpy as np
    import torch

    from ..ops import freq_solvers

    tol = guard_tol() if tol is None else tol
    r = np.random.default_rng(13)
    worst = 0.0
    for m in sorted(set(int(s) for s in sizes)):
        q, _ = np.linalg.qr(r.normal(size=(batch, m, m))
                            + 1j * r.normal(size=(batch, m, m)))
        lam = np.logspace(0.0, np.log10(cond), m)
        G = torch.from_numpy(
            (q * lam[None, None, :]) @ q.conj().transpose(0, 2, 1)
        ).to(device=device, dtype=torch.complex64)
        G = 0.5 * (G + G.conj().transpose(-1, -2))
        try:
            got = freq_solvers.hermitian_inverse(G, method)
            ref = freq_solvers.hermitian_inverse(G, "cholesky")
            dev = float((got - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-30)
        except Exception:
            return False, float("inf")
        if dev != dev:  # NaN
            return False, float("inf")
        worst = max(worst, dev)
    return worst <= tol, worst


def gram_sizes(kind: str, geom, data_shape=None, cfg=None,
               workload: str = "") -> Tuple[int, ...]:
    """The sizes of the Gram matrices a workload inverts through
    ``herm_inv``: the z-kernel's W x W when the geometry has a reduce
    axis (W > 1), and a learner's d-pass Gram over its images per block
    (a masked learner's over all of them)."""
    import math

    sizes = {math.prod(geom.reduce_shape)}
    if kind == "learn":
        n = int(data_shape[0])
        blocks = 1 if workload.startswith("masked") else cfg.num_blocks
        sizes.add(max(1, n // max(1, blocks)))
    return tuple(sorted(s for s in sizes if s > 1))


def _arm_herm_method(kind, new_cfg, env_updates) -> Optional[str]:
    """The Gram-inverse method an applied arm selects, or None."""
    if kind == "solve":
        return new_cfg.herm_inv
    return env_updates.get(space.knobs("learn")["herm_inv"].env)


_GUARDS = {"learn": guard_learn, "solve": guard_solve}


# ---------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------

def _safe_save(store) -> None:
    try:
        store.save()
    except OSError:  # a read-only deploy still resolves, just uncached
        pass


def _resolve(kind: str, cfg, shape_key: str, workload: str,
             chip: Optional[str], store, emit, guard, device,
             guard_tol_override: Optional[float] = None, grams=()):
    """Core auto-resolution. ``guard``: None = the real numerics guard
    (skipped for arms that move only trajectory-exact knobs and when
    ``CCSC_TUNE_GUARD=0``): the trajectory guard, and for an arm that
    selects a Gram-inverse method :func:`guard_gram` at the workload's
    Gram sizes ``grams``; False = skip; callable(kind, arm, tol) ->
    (ok, dev) = injected. Returns (cfg, picked entry or None,
    env_updates)."""
    emit = emit or _default_emit
    chip = chip or chip_now(device)
    store = store or store_mod.TunedStore()
    tol = guard_tol() if guard_tol_override is None else guard_tol_override
    cands = store.candidates(chip, kind, shape_key)
    if not cands:
        others = store.chips_with_entries(kind, shape_key)
        reason = (
            f"cross-chip refusal: tuned entries exist for chip(s) "
            f"{'/'.join(others)} but this run is on {chip}"
            if others else "no tuned entry for this chip/shape"
        )
        emit("tune_pick", kind=kind, chip=chip, shape_key=shape_key,
             arm=None, reason=reason)
        if others:
            _console(f"tune: {reason} — running the untuned defaults "
                     "(measure this chip with tune='sweep' or python -m "
                     "ccsc_code_iccv2017_torch.tune.autotune --sweep)")
        return cfg, None, {}

    knob_table = space.knobs(kind)
    for entry in cands:
        arm = entry["arm"]
        new_cfg, env_updates, dropped = space.apply_arm(cfg, arm, kind,
                                                        workload)
        if arm and len(dropped) == len(arm):
            # nothing of this arm applies to this workload
            continue
        all_exact = all(knob_table[n].exact for n in arm if n in knob_table)
        cached = entry.get("guard")
        need_guard = (
            guard is not False
            and _guard_enabled()
            and not all_exact
            and not (cached and cached.get("ok")
                     and cached.get("tol", 0.0) <= tol)
        )
        if need_guard:
            if guard is None:
                ok, dev = _GUARDS[kind](arm, tol, workload, device=device)
                method = _arm_herm_method(kind, new_cfg, env_updates)
                if ok and method is not None and grams:
                    ok, g_dev = guard_gram(method, grams, tol, device)
                    dev = max(dev, g_dev)
            else:
                ok, dev = guard(kind, arm, tol)
            store.mark_guard(chip, kind, shape_key, arm, ok, dev, tol)
            emit("tune_guard", kind=kind, chip=chip, shape_key=shape_key,
                 arm=arm, ok=bool(ok),
                 dev=None if dev != dev or dev == float("inf")
                 else round(dev, 8),
                 tol=tol)
            if not ok:
                store.demote(chip, kind, shape_key, arm,
                             reason=f"numerics guard: dev {dev:.3g} > "
                                    f"tol {tol:g}")
                _safe_save(store)
                _console(f"tune: demoting arm [{space.arm_label(arm)}] — "
                         f"trajectory deviation {dev:.3g} exceeds the "
                         f"{tol:g} guard tolerance on {chip}; trying the "
                         "next-best arm")
                continue
            _safe_save(store)
        emit("tune_pick", kind=kind, chip=chip, shape_key=shape_key,
             arm=arm, value=entry.get("value"), unit=entry.get("unit"),
             source=entry.get("source"),
             dropped=[list(d) for d in dropped] or None)
        return new_cfg, entry, env_updates
    emit("tune_pick", kind=kind, chip=chip, shape_key=shape_key, arm=None,
         reason="every candidate arm was demoted")
    return cfg, None, {}


def resolve_learn(cfg, geom, data_shape, workload: str = "consensus2d",
                  chip: Optional[str] = None, store=None, emit=None,
                  guard=None, apply_env: bool = True, device="cuda"):
    """Resolve a LearnConfig under its ``tune`` mode (no-op for 'off').
    ``data_shape`` is the full data batch shape [n, ...]. Returns
    (cfg with tune='off', picked entry or None). With ``apply_env`` the
    arm's env knobs (``CCSC_HERM_INV``) are set in ``os.environ``:
    startup-time resolution only, never mid-learn."""
    if cfg.tune == "off":
        return cfg, None
    store = store or store_mod.TunedStore()
    key = _learn_key(cfg, geom, data_shape, workload)
    if cfg.tune == "sweep":
        sweep_learn(cfg, geom, data_shape, workload=workload, chip=chip,
                    store=store, emit=emit, device=device)
    new_cfg, picked, env_updates = _resolve(
        "learn", cfg, key, workload, chip, store, emit, guard, device,
        grams=gram_sizes("learn", geom, data_shape, cfg, workload))
    if apply_env:
        os.environ.update(env_updates)
    return dataclasses.replace(new_cfg, tune="off"), picked


def resolve_solve(cfg, geom, spatial, workload: str = "solve2d",
                  chip: Optional[str] = None, store=None, emit=None,
                  guard=None, mesh=None, device="cuda"):
    """Resolve a SolveConfig under its ``tune`` mode (no-op for 'off').
    ``spatial``: the observation's spatial shape (an engine passes its
    largest bucket). ``mesh``: a serving-mesh shape, which suffixes the
    store key (a sharded engine tunes under its own entries). Returns
    (cfg with tune='off', picked entry or None)."""
    if cfg.tune == "off":
        return cfg, None
    store = store or store_mod.TunedStore()
    key = store_mod.solve_shape_key(
        workload, k=geom.num_filters, support=geom.spatial_support,
        spatial=tuple(int(s) for s in spatial), mesh=mesh)
    if cfg.tune == "sweep":
        sweep_solve(cfg, geom, spatial, workload=workload, chip=chip,
                    store=store, emit=emit, mesh=mesh, device=device)
    new_cfg, picked, _ = _resolve("solve", cfg, key, workload, chip, store,
                                  emit, guard, device,
                                  grams=gram_sizes("solve", geom))
    return dataclasses.replace(new_cfg, tune="off"), picked


def _learn_key(cfg, geom, data_shape, workload):
    n = int(data_shape[0])
    spatial = tuple(int(s) for s in data_shape[1 + geom.ndim_reduce:])
    return store_mod.learn_shape_key(
        workload, k=geom.num_filters, support=geom.spatial_support, n=n,
        size=spatial, blocks=cfg.num_blocks)


# ---------------------------------------------------------------------
# sweep: time the arms on this device, persist the ranking
# ---------------------------------------------------------------------

def _sample(fn: Callable[[], object], per_call: float, device) -> float:
    """One timed call of ``fn``, as calls a second times ``per_call``: on
    the card its CUDA-event time (utils.device.device_time_ms), on the
    CPU the host clock's."""
    import torch

    if torch.device(device).type == "cuda":
        from ..utils.device import device_time_ms

        ms = device_time_ms(fn, reps=1, warmup=0)
        return per_call * 1e3 / max(ms, 1e-9)
    t0 = time.perf_counter()
    fn()
    return per_call / max(time.perf_counter() - t0, 1e-9)


def _learn_arm_call(cfg, geom, data_shape, device, iters: int = 2):
    """(call, outer iterations a call) of one arm'd LearnConfig on
    synthetic data at the run's shape, through the step the driver would
    run for it (an outer_chunk / donate_state arm through the chunked
    step), after one warm call."""
    import torch

    from ..models import common, learn as learn_mod
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    n = int(data_shape[0])
    spatial = tuple(int(s) for s in data_shape[1 + geom.ndim_reduce:])
    blocks = cfg.num_blocks
    ni = n // blocks
    fg = common.FreqGeom.create(geom, spatial, fft_pad=cfg.fft_pad,
                                fft_impl=cfg.fft_impl)
    cfg = dataclasses.replace(cfg, max_it=iters, tol=0.0, verbose="none",
                              track_objective=False, metrics_dir=None,
                              watchdog=False, tune="off")
    gen = torch.Generator(device=dev).manual_seed(1)
    b = torch.randn((blocks, ni, *geom.reduce_shape, *spatial),
                    generator=gen, device=dev)
    state = [learn_mod.init_state(
        torch.Generator(device=dev).manual_seed(0), geom, fg, blocks, ni,
        z_dtype=getattr(torch, cfg.storage_dtype),
        d_dtype=getattr(torch, cfg.d_storage_dtype))]
    chunk = max(1, cfg.outer_chunk) if cfg.chunked_driver else 1

    def call():
        for _ in range(iters):
            if cfg.chunked_driver:
                state[0], tr = learn_mod.outer_chunk_scan(
                    state[0], b, geom, cfg, fg, blocks, chunk,
                    donate=cfg.donate_state)
                fence = tr.metrics.d_diff[-1]
            else:
                state[0], m = learn_mod.outer_step(state[0], b, geom, cfg,
                                                   fg, blocks)
                fence = m.d_diff
        return float(fence)

    call()  # warm: builds the kernels and plans
    return call, iters * chunk


def _solve_arm_call(cfg, geom, spatial, d, device, reps: int = 2,
                    batch: int = 1):
    """(call, solves a call) of one arm'd SolveConfig on a synthetic
    masked observation of ``batch`` images at the bucket shape, after
    one warm call."""
    import numpy as np

    from ..models.reconstruct import ReconstructionProblem, reconstruct

    cfg = dataclasses.replace(cfg, verbose="none", track_objective=False,
                              track_psnr=False, metrics_dir=None, tol=0.0,
                              tune="off")
    prob = ReconstructionProblem(geom)
    r = np.random.default_rng(5)
    x = r.random((batch, *geom.reduce_shape, *spatial)).astype(np.float32)
    m = (r.random(x.shape) < 0.6).astype(np.float32)

    def call():
        for _ in range(reps):
            res = reconstruct(x * m, d, prob, cfg, mask=m, device=device)
        return int(res.trace.num_iters)

    call()  # warm: builds the plan
    return call, reps


def _sweep(kind, cfg, key, workload, chip, store, emit, arms, timer,
           pairs, unit, make_call, device):
    """Time every arm in ``pairs`` interleaved pairs against the
    baseline (baseline then arm, then arm then baseline, and so on, so a
    drift of the card's clock or of the host weighs on both alike), then
    record each arm's median rate and demote the arms that
    :func:`_drop_losers` does not accept. ``timer(armed_cfg, arm)`` ->
    one rate sample is injectable; the default builds each arm's call
    once (``make_call(armed_cfg) -> (call, per_call)``) and times one
    call a sample. An arm that fails to run records nothing."""
    import statistics

    calls = {}

    def sample(armed, arm, env_updates):
        with _env_applied(env_updates):
            if timer is not None:
                return float(timer(armed, arm))
            label = space.arm_label(arm)
            if label not in calls:
                calls[label] = make_call(armed)
            fn, per_call = calls[label]
            return _sample(fn, per_call, device)

    def fail(arm, e):
        emit("tune_arm", kind=kind, chip=chip, shape_key=key, arm=arm,
             error=str(e)[:200])

    arms = list(space.default_arms(kind, workload) if arms is None else arms)
    try:
        base = [sample(cfg, {}, {})]
    except Exception as e:
        fail({}, e)
        return store
    paired = []
    for arm in arms:
        if not arm:
            continue
        armed, env_updates, dropped = space.apply_arm(cfg, arm, kind,
                                                      workload)
        if dropped and len(dropped) == len(arm):
            continue  # nothing of this arm applies here
        got = []
        try:
            for p in range(pairs):
                order = (False, True) if p % 2 == 0 else (True, False)
                pair = {}
                for is_arm in order:
                    pair[is_arm] = (sample(armed, arm, env_updates) if is_arm
                                    else sample(cfg, {}, {}))
                got.append((pair[False], pair[True]))
        except Exception as e:
            fail(arm, e)
            continue
        finally:
            calls.pop(space.arm_label(arm), None)  # one arm's state at a time
        base.extend(b for b, _ in got)
        paired.append((arm, got))
    base_rate = statistics.median(base)
    store.add(chip, kind, key, {}, base_rate, unit, source="sweep")
    emit("tune_arm", kind=kind, chip=chip, shape_key=key, arm={},
         value=round(base_rate, 5), unit=unit, samples=len(base))
    for arm, got in paired:
        rate = statistics.median(a for _, a in got)
        store.add(chip, kind, key, arm, rate, unit, source="sweep")
        emit("tune_arm", kind=kind, chip=chip, shape_key=key, arm=arm,
             value=round(rate, 5), unit=unit,
             pairs=[[round(b, 5), round(a, 5)] for b, a in got])
    _drop_losers(store, chip, kind, key, base, paired)
    _safe_save(store)
    return store


def sweep_learn(cfg, geom, data_shape, workload: str = "consensus2d",
                chip: Optional[str] = None, store=None, emit=None,
                arms=None, timer: Optional[Callable] = None, iters: int = 2,
                pairs: int = 4, device="cuda"):
    """Time the candidate arms at this run's shape against the baseline
    (:func:`_sweep`) and persist the ranking."""
    key = _learn_key(cfg, geom, data_shape, workload)
    return _sweep(
        "learn", cfg, key, workload, chip or chip_now(device),
        store or store_mod.TunedStore(), emit or _default_emit, arms, timer,
        pairs, "outer_iters/sec",
        lambda armed: _learn_arm_call(armed, geom, data_shape, device,
                                      iters=iters),
        device)


def sweep_solve(cfg, geom, spatial, workload: str = "solve2d",
                chip: Optional[str] = None, store=None, emit=None,
                arms=None, timer: Optional[Callable] = None, d=None,
                reps: int = 2, mesh=None, batch: int = 1, pairs: int = 4,
                device="cuda"):
    """The solve-side sweep at one bucket shape and ``batch`` images a
    solve (see :func:`_sweep`); ``mesh`` suffixes the store key as
    :func:`resolve_solve`'s does."""
    spatial = tuple(int(s) for s in spatial)
    key = store_mod.solve_shape_key(
        workload, k=geom.num_filters, support=geom.spatial_support,
        spatial=spatial, mesh=mesh)
    if timer is None and d is None:
        import numpy as np

        r = np.random.default_rng(2)
        d = r.normal(size=(geom.num_filters, *geom.reduce_shape,
                           *geom.spatial_support)).astype(np.float32)
        d /= np.sqrt((d**2).sum(axis=tuple(range(1, d.ndim)),
                               keepdims=True))
    return _sweep(
        "solve", cfg, key, workload, chip or chip_now(device),
        store or store_mod.TunedStore(), emit or _default_emit, arms, timer,
        pairs, "solves/sec",
        lambda armed: _solve_arm_call(armed, geom, spatial, d, device,
                                      reps=reps, batch=batch),
        device)


def _drop_losers(store, chip, kind, shape_key, base, paired) -> None:
    """Demote every arm that does not win most of its pairs by more
    than the margin: the larger of ``CCSC_TUNE_MIN_WIN`` (default 2%)
    and the baseline's own spread over the sweep ((max - min) / median
    of its samples). A win inside the baseline's spread is noise, and
    falling back past the baseline means the defaults, which need no
    entry."""
    import statistics

    from ..utils import env as _env

    med = statistics.median(base)
    spread = (max(base) - min(base)) / med if med > 0 else float("inf")
    margin = max(_env.env_float("CCSC_TUNE_MIN_WIN"), spread)
    for arm, got in paired:
        wins = sum(a > b * (1.0 + margin) for b, a in got)
        if 2 * wins <= len(got):
            store.demote(chip, kind, shape_key, arm,
                         reason=f"sweep: won {wins} of {len(got)} pairs by "
                                f"more than {margin:.3g} (the baseline's "
                                f"spread {spread:.3g})")


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ccsc_code_iccv2017_torch.tune.autotune",
        description="knob autotuner: validate the arm space, list the "
        "store, or sweep the arms on this device",
    )
    p.add_argument("--store", default=None, help="tuned store path")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dry-run", action="store_true",
                      help="validate the arm space without running anything")
    mode.add_argument("--seed-from", default=None, metavar="JSONL",
                      help="not ported: the seeders read the JAX "
                      "package's bench rounds (exits 2)")
    mode.add_argument("--list", action="store_true",
                      help="print the store contents")
    mode.add_argument("--sweep", default=None, choices=["learn", "solve"],
                      help="time the candidate arms on this device")
    p.add_argument("--workload", default=None,
                   help="workload token (default consensus2d / solve2d)")
    p.add_argument("--n", type=int, default=16, help="sweep: images")
    p.add_argument("--size", type=int, default=32, help="sweep: spatial side")
    p.add_argument("--k", type=int, default=16, help="sweep: filters")
    p.add_argument("--support", type=int, default=7,
                   help="sweep: filter support")
    p.add_argument("--blocks", type=int, default=2,
                   help="sweep(learn): consensus blocks")
    p.add_argument("--iters", type=int, default=2,
                   help="sweep: iterations/solves in one timed sample")
    p.add_argument("--pairs", type=int, default=4,
                   help="sweep: interleaved baseline/arm pairs per arm")
    p.add_argument("--batch", type=int, default=1,
                   help="sweep(solve): images a solve")
    p.add_argument("--device", default="cuda",
                   help="device to sweep on (default cuda)")
    return p


def _dry_run() -> int:
    from .. import config

    n_bad = 0
    for kind, cls, workload in (
        ("learn", config.LearnConfig, "consensus2d"),
        ("solve", config.SolveConfig, "solve2d"),
    ):
        unclassified, missing = space.classify_drift(kind, cls)
        if unclassified or missing:
            print(f"DRIFT in {kind}: unclassified fields "
                  f"{sorted(unclassified)}, declared-but-missing "
                  f"{sorted(missing)}")
            n_bad += 1
        arms = space.default_arms(kind, workload)
        print(f"{kind} ({workload}): {len(arms)} candidate arms")
        for arm in arms:
            armed, env, dropped = space.apply_arm(cls(), arm, kind, workload)
            dataclasses.asdict(armed)  # the constructor validated it
            note = f" env={env}" if env else ""
            note += f" dropped={dropped}" if dropped else ""
            print(f"  {space.arm_label(arm)}{note}")
    print(f"code fingerprint: {space.code_fingerprint()}")
    print(f"store path: {store_mod.default_store_path()}")
    if n_bad:
        print("DRY RUN FAILED: knob space drift detected")
    return 1 if n_bad else 0


def _list(store) -> int:
    data = store._data
    if not data:
        print(f"(store empty: {store.path})")
        return 0
    for key in sorted(data):
        print(key)
        for e in data[key]:
            flags = []
            if e.get("demoted"):
                flags.append(f"DEMOTED({e.get('demote_reason', '')})")
            g = e.get("guard")
            if g:
                flags.append(f"guard={'ok' if g.get('ok') else 'FAIL'}"
                             f"@{g.get('dev'):.3g}")
            print(f"  {e.get('value'):>10.4g} {e.get('unit'):<16} "
                  f"[{json.dumps(e.get('arm'))}] {e.get('source', '')} "
                  f"{' '.join(flags)}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dry_run:
        return _dry_run()
    if args.seed_from:
        print("--seed-from: the store seeders read the JAX package's "
              "bench rounds and are not ported (ROADMAP.md item 10); "
              "sweep this device instead", file=sys.stderr)
        return 2
    store = store_mod.TunedStore(args.store)
    if args.list:
        return _list(store)
    from ..config import LearnConfig, ProblemGeom, SolveConfig

    def emit(type_, **fields):
        print(json.dumps({"type": type_, **fields}), flush=True)

    geom = ProblemGeom((args.support, args.support), args.k)
    if args.sweep == "learn":
        sweep_learn(LearnConfig(num_blocks=args.blocks, verbose="none"),
                    geom, (args.n, args.size, args.size),
                    workload=args.workload or "consensus2d", store=store,
                    emit=emit, iters=args.iters, pairs=args.pairs,
                    device=args.device)
    else:
        sweep_solve(SolveConfig(max_it=max(args.iters * 5, 10),
                                verbose="none"),
                    geom, (args.size, args.size),
                    workload=args.workload or "solve2d", store=store,
                    emit=emit, reps=args.iters, pairs=args.pairs,
                    batch=args.batch, device=args.device)
    print(f"sweep recorded -> {store.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
