"""The declared candidate knob space of the autotuner (the port's own
copy of ``ccsc_code_iccv2017_tpu.tune.space``, which imports no jax but
belongs to the JAX package).

One place answers three questions:

1. WHICH config fields are performance knobs — execution-strategy
   levers whose every value solves the same problem (to equality or
   documented float tolerance) — versus algorithmic parameters that
   change the problem (lambda, rho, max_it). Every LearnConfig /
   SolveConfig field must be classified here; the drift-guard unit
   test (tests/test_autotune.py) fails on an unclassified field, so a
   new knob cannot silently escape tuning.
2. WHAT candidate values each knob takes, and which workloads it
   applies to (fused_z engages only in the 2D W==1 consensus
   learners; carry_freq only in the masked learner).
3. HOW an arm (a dict of non-default knob values) is applied to a
   config — dataclasses.replace for config-field knobs, an env update
   for the env knobs (the learners' Gram-inverse method,
   CCSC_HERM_INV), with inapplicable knobs dropped by workload
   instead of crashing the run.

One divergence from JAX's table: ``use_pallas`` is not a solve knob
here. The port never reads it (on the card the W == 1 z-solve always
runs the hand-written K1), so an arm moving it would time the same
program twice and could only crown a noise winner; and no arm may put
a kernel's plain version on the main path. It stands in
NON_TUNED_SOLVE with that reason.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

# Bump when the meaning of a knob or the application mechanics change
# incompatibly: the code fingerprint below keys every store entry, so
# old entries stop matching instead of silently configuring new code.
# JAX's version, kept: the port's knob table already differs from JAX's
# (no use_pallas solve knob), so the fingerprint, which hashes the
# table, tells the two packages' entries apart without a bump.
SPACE_VERSION = 2


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable execution-strategy lever.

    ``field``: True when the knob is a config dataclass field
    (applied via dataclasses.replace); False for trace-time env knobs
    (``env`` names the variable). ``workloads``: None = applies to
    every workload of its kind; else workload-token PREFIXES it may be
    applied to (see store.learn_shape_key — 'masked' matches
    'masked2d' and 'masked2d+r1'). ``exact``: True when every value is
    trajectory-exact (pure execution change — the numerics guard can
    be skipped for arms that only move exact knobs)."""

    values: Tuple
    field: bool = True
    env: Optional[str] = None
    workloads: Optional[Tuple[str, ...]] = None
    exact: bool = False

    def applies_to(self, workload: str) -> bool:
        if self.workloads is None or not workload:
            return True
        return any(workload.startswith(w) for w in self.workloads)


# ---- LearnConfig ----------------------------------------------------
LEARN_KNOBS: Dict[str, Knob] = {
    "storage_dtype": Knob(("float32", "bfloat16")),
    "d_storage_dtype": Knob(("float32", "bfloat16")),
    "fft_impl": Knob(("xla", "matmul", "matmul_high", "matmul_bf16")),
    "fused_z": Knob((False, True), workloads=("consensus2d",)),
    "fused_z_precision": Knob(
        ("highest", "high", "default"), workloads=("consensus2d",)
    ),
    "fft_pad": Knob(("none", "pow2", "fast")),
    "outer_chunk": Knob((1, 4), exact=True),
    # streaming rejects donation (no whole-state jitted step)
    "donate_state": Knob((False, True), exact=True,
                         workloads=("consensus", "masked")),
    "carry_freq": Knob((False, True), workloads=("masked",)),
    # the learners resolve the Gram-inverse method from CCSC_HERM_INV
    # when a step is built (ops.freq_solvers.resolve_herm_method) — an
    # env knob, not a LearnConfig field
    "herm_inv": Knob(("cholesky", "schur", "newton"), field=False,
                     env="CCSC_HERM_INV"),
}

# Non-tuned LearnConfig fields, by reason. Algorithmic: changes the
# optimization problem or its trajectory semantics. Operational:
# telemetry/resilience switches orthogonal to execution speed.
# Deprecated: kept for config compat, no longer routes anywhere.
NON_TUNED_LEARN: Dict[str, str] = {
    "lambda_residual": "algorithmic",
    "lambda_prior": "algorithmic",
    "max_it": "algorithmic",
    "tol": "algorithmic",
    "max_it_d": "algorithmic",
    "max_it_z": "algorithmic",
    "rho_d": "algorithmic",
    "rho_z": "algorithmic",
    "num_blocks": "algorithmic (consensus structure)",
    "dtype": "algorithmic (compute precision contract)",
    "verbose": "operational",
    "track_objective": "operational",
    "compat_coding": "algorithmic (reference-compat semantics)",
    "use_pallas": "not read by the port (on the card the composition's "
                  "W == 1 z-solve always runs K1; fused_z is the "
                  "learners' kernel lever)",
    "max_recoveries": "operational",
    "rho_backoff": "operational",
    "metrics_dir": "operational",
    "watchdog": "operational",
    "watchdog_slack": "operational",
    "tune": "operational (the autotuner's own switch)",
}

# ---- SolveConfig ----------------------------------------------------
SOLVE_KNOBS: Dict[str, Knob] = {
    "storage_dtype": Knob(("float32", "bfloat16")),
    "fft_impl": Knob(("xla", "matmul", "matmul_high", "matmul_bf16")),
    "fft_pad": Knob(("none", "pow2", "fast")),
    # SolveConfig carries the method explicitly (plumbed through
    # ReconPlan/precompute_z_kernel) so a serving engine can pin it
    # per-config instead of per-process env; None = the library's
    # platform/size-aware default. Only W > 1 problems (a reduce
    # axis: demosaic/view-synth) have a matrix inner inverse — at
    # W == 1 the knob is a no-op and timing it only invites a
    # noise-ranked 'winner'.
    "herm_inv": Knob(
        (None, "cholesky", "schur", "newton"),
        workloads=("solve2d+r", "solve3d+r", "solve4d+r"),
    ),
}

NON_TUNED_SOLVE: Dict[str, str] = {
    "lambda_residual": "algorithmic",
    "lambda_prior": "algorithmic",
    "max_it": "algorithmic",
    "tol": "algorithmic",
    "gamma_factor": "algorithmic",
    "gamma_ratio": "algorithmic",
    "scale_rho_by_reduce": "algorithmic (reference-compat semantics)",
    "lambda_smooth": "algorithmic",
    "dtype": "algorithmic (compute precision contract)",
    "verbose": "operational",
    "track_objective": "operational",
    "track_psnr": "operational",
    "track_diagnostics": "operational (quality observatory readback)",
    "use_pallas": "not read by the port: on the card the W == 1 "
                  "z-solve always runs the hand-written K1, so no arm "
                  "may move it (and none may route a solve to K1's "
                  "plain version)",
    "metrics_dir": "operational",
    "tune": "operational (the autotuner's own switch)",
}

# Knob values that run, for parity with the JAX package, but that no
# sweep times until a measured cell shows them paying on the card: on an
# H100 (chip_smoke.py phase 22) the emulated bf16 DFT tiers cost 2.2x
# and 6.4x the float32 'matmul' tier and are less precise, and the
# guarded Newton inverse computes a Cholesky inverse beside its own
# (137 against 19 ms on the north star's d-pass Gram). An arm holding
# one of them is left out of default_arms; set by hand, it still runs.
PARITY_ONLY: Dict[str, Tuple] = {
    "fft_impl": ("matmul_high", "matmul_bf16"),
    "herm_inv": ("newton",),
}

_KNOBS = {"learn": LEARN_KNOBS, "solve": SOLVE_KNOBS}
_NON_TUNED = {"learn": NON_TUNED_LEARN, "solve": NON_TUNED_SOLVE}


def knobs(kind: str) -> Dict[str, Knob]:
    return _KNOBS[kind]


def classify_drift(kind: str, config_cls) -> Tuple[set, set]:
    """(unclassified config fields, declared-but-missing field knobs)
    — both must be empty; the drift-guard test asserts it."""
    fields = {f.name for f in dataclasses.fields(config_cls)}
    tuned = _KNOBS[kind]
    classified = set(tuned) | set(_NON_TUNED[kind])
    unclassified = fields - classified
    missing = {
        n for n, k in tuned.items() if k.field and n not in fields
    }
    return unclassified, missing


def code_fingerprint() -> str:
    """Content fingerprint of the knob space (names, values,
    application mechanics version). Keys every store entry: when the
    space changes incompatibly, persisted winners stop matching
    instead of silently configuring code they were never measured
    on. CCSC_TUNE_FP overrides (pinning across a compatible rename)."""
    from ..utils import env as _env

    override = _env.env_str("CCSC_TUNE_FP")
    if override:
        return override
    basis = {
        "version": SPACE_VERSION,
        "knobs": {
            kind: {
                name: [str(v) for v in k.values]
                for name, k in sorted(table.items())
            }
            for kind, table in _KNOBS.items()
        },
    }
    return hashlib.sha256(
        json.dumps(basis, sort_keys=True).encode()
    ).hexdigest()[:12]


def knob_defaults(kind: str, cfg=None) -> Dict[str, object]:
    """Default value of every knob (from ``cfg``'s class when given,
    else the shipped config defaults; env knobs default to None, the
    library default)."""
    from .. import config as _config

    cls = type(cfg) if cfg is not None else (
        _config.LearnConfig if kind == "learn" else _config.SolveConfig
    )
    out = {}
    for name, k in _KNOBS[kind].items():
        if k.field:
            out[name] = next(
                f.default for f in dataclasses.fields(cls)
                if f.name == name
            )
        else:
            out[name] = None  # env unset = library default
    return out


def apply_arm(
    cfg, arm: Dict[str, object], kind: str, workload: str = ""
):
    """Apply an arm to ``cfg``.

    Returns (new_cfg, env_updates, dropped): env_updates is the
    {ENV_VAR: value} map for non-field knobs (the caller decides when
    to set them — at startup resolution, never inside a library call);
    dropped lists (knob, reason) pairs for knobs that do not apply to
    this workload or are unknown to this kind — applying a consensus
    arm to a masked learner must configure what transfers and say
    what did not, not crash the run."""
    table = _KNOBS[kind]
    updates: Dict[str, object] = {}
    env: Dict[str, str] = {}
    dropped: List[Tuple[str, str]] = []
    for name, value in arm.items():
        k = table.get(name)
        if k is None:
            dropped.append((name, f"not a {kind} knob"))
            continue
        if not k.applies_to(workload):
            defaults = knob_defaults(kind, cfg)
            if value != defaults.get(name):
                dropped.append(
                    (name, f"not applicable to workload '{workload}'")
                )
            continue
        if k.field:
            updates[name] = value
        elif value is not None:
            env[k.env] = str(value)
    new_cfg = dataclasses.replace(cfg, **updates) if updates else cfg
    return new_cfg, env, dropped


def arm_knob_dict(cfg, kind: str, env_applied=None) -> Dict[str, object]:
    """The resolved knob dict of a config — what actually executes —
    for telemetry records (serve_warmup, tune_pick)."""
    out = {}
    for name, k in _KNOBS[kind].items():
        if k.field:
            out[name] = getattr(cfg, name)
        else:
            import os

            out[name] = (env_applied or {}).get(
                k.env, os.environ.get(k.env)
            )
    return out


def default_arms(kind: str, workload: str = "") -> List[Dict[str, object]]:
    """The sweep's candidate arm list: the baseline, every applicable
    single-knob move, and a few multi-knob combos carried over from the
    JAX package's list as candidates (what wins on the H100 is what the
    sweep measures there). An arm is a dict of NON-default knobs; none
    holds a PARITY_ONLY value."""
    table = _KNOBS[kind]
    defaults = knob_defaults(kind)

    def applicable(name):
        return table[name].applies_to(workload)

    def parity_only(arm):
        return any(v in PARITY_ONLY.get(n, ()) for n, v in arm.items())

    arms: List[Dict[str, object]] = [{}]
    for name, k in sorted(table.items()):
        if not applicable(name):
            continue
        for v in k.values:
            if v == defaults.get(name) or v is None or parity_only({name: v}):
                continue
            arms.append({name: v})
    combos = {
        "learn": [
            {"storage_dtype": "bfloat16", "d_storage_dtype": "bfloat16",
             "fft_impl": "matmul", "herm_inv": "schur"},
            {"storage_dtype": "bfloat16", "d_storage_dtype": "bfloat16",
             "fft_impl": "matmul_bf16", "herm_inv": "schur"},
            {"storage_dtype": "bfloat16", "d_storage_dtype": "bfloat16",
             "fft_impl": "matmul_bf16", "fused_z": True,
             "fused_z_precision": "default", "herm_inv": "schur"},
            {"storage_dtype": "bfloat16", "d_storage_dtype": "bfloat16",
             "fft_impl": "matmul_bf16", "fused_z": True,
             "fused_z_precision": "high", "herm_inv": "schur",
             "outer_chunk": 4, "donate_state": True},
        ],
        "solve": [
            {"storage_dtype": "bfloat16", "fft_impl": "matmul"},
            {"storage_dtype": "bfloat16", "fft_impl": "matmul_bf16",
             "herm_inv": "schur"},
        ],
    }[kind]
    for combo in combos:
        kept = {
            n: v for n, v in combo.items()
            if n in table and applicable(n)
        }
        if kept and kept not in arms and not parity_only(kept):
            arms.append(kept)
    return arms


def arm_label(arm: Dict[str, object]) -> str:
    if not arm:
        return "baseline"
    return ",".join(f"{k}={v}" for k, v in sorted(arm.items()))
