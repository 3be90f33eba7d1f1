"""BENCHMARK.json keeps the contract's shape, and every cell,
configuration, traffic mix and metric resolves by name to its files."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

from conftest import REPO, load
from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "ccsc_code_iccv2017_tpu"}
PROGRAM = "ccsc_code_iccv2017_torch"

BENCH = load("BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    _, config, traffic = run.resolve(BENCH, cell["name"], REPO)
    assert config["name"] == cell["config"]
    assert os.path.exists(os.path.join(
        REPO, "portbench", "systems", config["system"] + ".py"))
    assert "driver" in traffic
    metrics = run.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in metrics}
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(BENCH, cell, True)
    # the pair of configuration and traffic appears once
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("portbench/configs/")
    cfg = load(entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert entry["source"].startswith("https://")
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.reader(REPO, metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(metric["workloads"]) <= cells
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_layer_names_and_four_chip_share():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _sources(sub=""):
    top = os.path.join(REPO, "portbench", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """By whole top-level name: the port's name begins with the JAX
    package's, so a prefix match would confuse them."""
    for path in _sources():
        for top, level in _imports(path):
            assert level or top not in FORBIDDEN, (path, top)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for top, level in _imports(path):
            assert level or top not in FORBIDDEN | {PROGRAM}, (path, top)
            if level:
                # only its own modules: never the harness's
                assert level == 1, (path, top)


def test_result_line_keys_order(tiny_root):
    """The last key of a result is the checks, each with value and limit."""
    import time

    r = run.run_cell("serve-inpaint256-one-client", 3, 1.0, False,
                     root=tiny_root, device="cpu", t_start=time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)
