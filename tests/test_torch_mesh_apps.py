"""The learner apps' ``--mesh N`` of the port against the JAX apps'
``--mesh N`` (``block_mesh(N)`` on the 8-device CPU platform,
tests/conftest.py) and against the port's one-device run.

``learn_2d``, ``learn_3d`` and ``learn_4d`` each run with ``--mesh 2
--device cpu`` inside two gloo ranks started by one module-scoped
``parallel.distributed.launch`` (the path a ``torchrun`` launch takes:
``main`` joins the group it finds), the learner's init replaced by the
JAX init of ``PRNGKey(--seed)`` as tests/test_torch_learn_apps.py
replaces it; rank 0 writes the outputs. A last test runs ``learn_2d
--mesh 2 --device cpu`` from this process, where the app starts its two
ranks itself, against its one-device run from the same seed. Limits:
filters within 1e-4 of their scale, reconstructions within 1e-4 of the
data's.
"""
import os

import numpy as np
import pytest
import scipy.io

from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.parallel import distributed

import torch_mesh_cases as cases
from test_torch_learn_apps import APP_ARGV, _apps, _use_jax_inits

L2D_ARGV = ["--filters", "4", "--support", "5", "--blocks", "2",
            "--max-it", "2", "--max-it-d", "2", "--max-it-z", "2"]
TAIL = ["--verbose", "none", "--seed", "3"]


def _write_pngs(path, n=4, side=20):
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        Image.fromarray(
            (rng.random((side, side)) * 255).astype(np.uint8)
        ).save(os.path.join(path, f"{i}.png"))


def _argv(name, tmp):
    if name == "learn_2d":
        data = str(tmp / "imgs")
        if not os.path.isdir(data):
            _write_pngs(data)
        return ["--data", data] + L2D_ARGV + TAIL
    return APP_ARGV[name][0] + TAIL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per app: (the JAX app's result, the port's one-device result, the
    port's rank-0 result on --mesh 2, the port's output file)."""
    tmp = tmp_path_factory.mktemp("mesh_apps")
    mp = pytest.MonkeyPatch()
    out, jobs = {}, []
    try:
        _use_jax_inits(mp)
        for name in ("learn_2d", "learn_3d", "learn_4d"):
            argv = _argv(name, tmp)
            japp, tapp = _apps(name)
            jr = japp.main(argv + ["--mesh", "2", "--out",
                                   str(tmp / f"j_{name}.mat")])
            inits = []
            jax_init = tlearn.init_state

            def record(*a, _f=jax_init, **k):
                st = _f(*a, **k)
                inits.append({f: getattr(st, f).numpy() for f in st._fields})
                return st

            mp.setattr(tlearn, "init_state", record)
            one = tapp.main(argv + ["--device", "cpu", "--out",
                                    str(tmp / f"one_{name}.mat")])
            mp.setattr(tlearn, "init_state", jax_init)
            tout = str(tmp / f"t_{name}.mat")
            jobs.append((f"ccsc_code_iccv2017_torch.apps.{name}",
                         argv + ["--mesh", "2", "--device", "cpu",
                                 "--out", tout], inits[0]))
            out[name] = [jr, one, None, tout]
    finally:
        mp.undo()
    got = distributed.launch(cases.run_apps, 2, args=(jobs,), device="cpu",
                             timeout=60.0, join_timeout=240.0)
    assert all(r is None for r in got[1])  # rank 1 returns nothing
    for name, res in zip(("learn_2d", "learn_3d", "learn_4d"), got[0]):
        out[name][2] = res
    return out


def _close(got, ref, scale, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("name", ["learn_2d", "learn_3d", "learn_4d"])
def test_app_mesh_matches_the_jax_app_mesh(runs, name):
    jr, one, tr, tout = runs[name]
    for ref in (jr, one):
        for k in ("obj_vals_d", "obj_vals_z"):
            np.testing.assert_allclose(tr.trace[k], ref.trace[k], rtol=1e-4)
        _close(tr.d.numpy(), ref.d, np.abs(np.asarray(ref.d)).max())
        # Dz is gathered on rank 0: the whole batch
        _close(tr.Dz.numpy(), ref.Dz,
               max(1.0, np.abs(np.asarray(ref.Dz)).max()))
    # rank 0 wrote the reference layout, read by the JAX loaders
    layout = {"learn_2d": "2d", "learn_3d": "3d",
              "learn_4d": "lightfield"}[name]
    load = getattr(jio, "load_filters_2d" if layout == "2d"
                   else f"load_filters_{layout}")
    np.testing.assert_array_equal(load(tout), tr.d.numpy())
    np.testing.assert_array_equal(jio.load_dz(tout, layout), tr.Dz.numpy())


def test_app_starts_its_own_ranks(tmp_path):
    """From a process outside any group, ``--mesh 2`` starts two ranks
    itself and lands on the one-device run from the same seed."""
    _, tapp = _apps("learn_2d")
    argv = _argv("learn_2d", tmp_path) + ["--device", "cpu"]
    mesh = tapp.main(argv + ["--mesh", "2", "--out", str(tmp_path / "m.mat")])
    one = tapp.main(argv + ["--out", str(tmp_path / "o.mat")])
    _close(mesh.d.numpy(), one.d.numpy(), np.abs(one.d.numpy()).max())
    _close(mesh.Dz.numpy(), one.Dz.numpy(), max(1.0, np.abs(
        one.Dz.numpy()).max()))
    assert scipy.io.loadmat(str(tmp_path / "m.mat"))["d"].shape == (5, 5, 4)
