"""Fixtures of the benchmark's own tests.

``tiny_root`` is a checkout-shaped directory whose ``BENCHMARK.json``
and configuration files are the real ones cut to a size the CPU runs in
seconds (8 filters, 32 x 32 requests in 2 slots; a learner of 16
filters on 2 blocks of 3 images of 20 x 20: with 8, ten d-iterations
shrink its dictionary until every code is zero); traffic files and
metric readers are found
beside the harness. Tests that need the card carry the ``cuda`` marker
and skip, inside a fixture, where there is none.
"""
from __future__ import annotations

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {
    "inpaint2d-k100-256": {"num_filters": 8, "side": 32,
                           "solve": {"max_it": 20},
                           "serve": {"slots": 2, "max_wait_ms": 2.0},
                           "check": {"sample": 4}},
    "learn2d-k100-8x100": {"num_filters": 16, "blocks": 2, "ni": 3,
                           "side": 20},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def _merge(base: dict, cut: dict) -> dict:
    out = dict(base)
    for k, v in cut.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def load(rel: str):
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def write(root, rel: str, obj) -> None:
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_root(tmp_path):
    bench = load("BENCHMARK.json")
    write(tmp_path, "BENCHMARK.json", bench)
    for c in bench["configs"]:
        write(tmp_path, c["file"], _merge(load(c["file"]),
                                          TINY.get(c["name"], {})))
    return str(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: none on this machine")
    return torch.device("cuda", 0)
