"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Everything is found by name:
``BENCHMARK.json`` names the cell, its configuration file and its
traffic (``portbench/traffic/<traffic>.json``); the configuration's
``system`` names the entry into the program (``portbench/systems/``);
every metric is read by ``portbench/metrics/<metric>.py``.

The run loads, warms the cell's shapes (counted in ``setup_s``),
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints as its last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``, each number compared beside its limit; the same
numbers are the last lines of standard error. It exits non-zero, and
prints no result, without enough CUDA devices, or if JAX or the JAX
package was loaded. ``--control 1`` runs the program's lower-precision
path instead (bf16 code storage): the control that the limits were set
against, never run by the benchmark's own runs.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, List, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ccsc_code_iccv2017_tpu")
# a traced serving run profiles the window's last TRACE_S seconds (the
# learner's, its whole call)
TRACE_S = 8.0


class Refused(Exception):
    """The run cannot give a result (exit code 2)."""


@dataclasses.dataclass
class Ctx:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    tracer: object
    device: str
    t_start: float
    control: bool = False
    # tests: stop a learner by count (a SIGINT would reach the test
    # runner)
    max_steps: Optional[int] = None

    @property
    def trace_at(self) -> float:
        """Seconds into the window at which the profiled stretch starts."""
        return max(0.0, self.seconds - TRACE_S)

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def find(root: str, rel: str) -> str:
    """A benchmark file by its path under the checkout: in ``root`` if it
    is there, else beside this harness."""
    p = os.path.join(root, rel)
    return p if os.path.exists(p) else os.path.join(ROOT, rel)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, name: str, root: str) -> Tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(find(root, cfg_entry["file"]))
    traffic = load_json(find(root, os.path.join(
        "portbench", "traffic", cell["traffic"] + ".json")))
    return cell, config, traffic


def reader(root: str, metric: str) -> Callable:
    path = find(root, os.path.join("portbench", "metrics", metric + ".py"))
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics, or with a
    trace its per-layer ones (those listing it, or those without a list
    that move an end-to-end metric it reports)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m["workloads"] or ("workloads" not in m
                                          and m["moves"] in mine)]


def clean_env(config: dict) -> dict:
    """Drop inherited CCSC_* knobs; set the configuration's own."""
    for k in [k for k in os.environ if k.startswith("CCSC_")]:
        del os.environ[k]
    env = dict(config.get("env", {}))
    os.environ.update(env)
    return env


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, device: str = "cuda", control: bool = False,
             max_steps: Optional[int] = None,
             t_start: float = T_START) -> dict:
    """One run of a cell; the result object (with ``checks``). Raises
    :class:`Refused` where the run cannot give one."""
    from .trace import Tracer, breakdown

    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell, config, traffic = resolve(bench, name, root)
    env = clean_env(config)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        raise Refused(f"{name} needs {cell['chips']} CUDA device(s); "
                      f"this machine has "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # an earlier line, and not one a reader of the last line could
        # take for a result
        print("knobs " + json.dumps({
            "card": card_line(), "cell": name, "seed": seed,
            "seconds": seconds, "trace": int(trace),
            "control": int(control), "env": env, "config": cell["config"],
            "traffic": cell["traffic"]}), flush=True)
    metrics = cell_metrics(bench, cell, trace)
    readers = {m["name"]: reader(root, m["name"]) for m in metrics}
    tracer = Tracer(trace)
    tracer.prepare()
    ctx = Ctx(cell, config, traffic, seed, seconds, tracer, device, t_start,
              control, max_steps)
    system = importlib.import_module("portbench.systems." + config["system"])
    out = system.run(ctx)
    bad = forbidden_modules()
    if bad:
        raise Refused("loaded in the run: " + ", ".join(bad))
    values = {}
    for m in metrics:
        v = readers[m["name"]](out.record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {
        "correct": bool(out.complete and all(c.ok for c in out.checks)),
        "attempted": out.attempted, "failed": out.failed,
        "metrics": values, "device": dev,
    }
    if trace and tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = breakdown(tracer.trace)
    # a number that could not be read is null, never NaN (not JSON)
    result["checks"] = {c.name: {"value": c.value if c.value == c.value
                                 else None, "limit": c.limit}
                        for c in out.checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), control=bool(args.control))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
