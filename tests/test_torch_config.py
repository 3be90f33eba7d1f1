"""The port's configuration, device helper and import boundary.

``ccsc_code_iccv2017_torch.config`` is a jax-free copy of the JAX
package's ``ProblemGeom``/``GEOM_2D``/``LearnConfig``/``SolveConfig``/
``ServeConfig``/``TenantSpec``/``FleetConfig``:
field names, defaults and validation must stay identical. The port's package and
``chip_smoke.py`` must never import jax or the JAX package.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_torch import config as tcfg
from ccsc_code_iccv2017_torch.utils import device as tdevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ccsc_code_iccv2017_torch")


def _fields(cls):
    return [(f.name, f.default, str(f.type)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize(
    "name", ["ProblemGeom", "LearnConfig", "SolveConfig", "ServeConfig",
             "TenantSpec", "FleetConfig"]
)
def test_fields_and_defaults_match_jax(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_geometry_properties_match_jax():
    for args in [((11, 11), 100), ((5, 7), 4), ((3, 3), 2, (4,))]:
        t, j = tcfg.ProblemGeom(*args), jcfg.ProblemGeom(*args)
        for prop in ("ndim_spatial", "ndim_reduce", "reduce_size",
                     "psf_radius", "filter_shape"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.padded_shape((20, 31)) == j.padded_shape((20, 31))
    assert dataclasses.asdict(tcfg.GEOM_2D()) == dataclasses.asdict(
        jcfg.GEOM_2D()
    )
    assert dataclasses.asdict(tcfg.GEOM_2D(k=8, s=5)) == dataclasses.asdict(
        jcfg.GEOM_2D(k=8, s=5)
    )


@pytest.mark.parametrize("verbose", ["none", "brief"])
@pytest.mark.parametrize("track", [None, True, False])
def test_tracking_properties_match_jax(verbose, track):
    kw = dict(verbose=verbose, track_objective=track, track_psnr=track)
    t, j = tcfg.SolveConfig(**kw), jcfg.SolveConfig(**kw)
    assert (t.with_objective, t.with_psnr) == (j.with_objective, j.with_psnr)


@pytest.mark.parametrize(
    "kw",
    [dict(tune="bogus"), dict(storage_dtype="float16"), dict(herm_inv="lu")],
)
def test_invalid_values_refused_like_jax(kw):
    with pytest.raises(ValueError):
        jcfg.SolveConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.SolveConfig(**kw)


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(tune="auto"), "item 9"),
        (dict(tune="sweep"), "item 9"),
        (dict(fft_impl="matmul"), "item 9"),
    ],
)
def test_unported_fields_raise_naming_roadmap(kw, item):
    jcfg.SolveConfig(**kw)  # valid in the JAX package
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        tcfg.SolveConfig(**kw)


@pytest.mark.parametrize("kw", [dict(metrics_dir="/nonexistent")])
def test_solve_values_ported_construct(kw):
    """The run telemetry's field, which the port refused until it wrote
    the stream: it constructs as in the JAX package."""
    t, j = tcfg.SolveConfig(**kw), jcfg.SolveConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize(
    "kw",
    [dict(tune="bogus"), dict(slo_p50_ms=0.0), dict(slo_check_s=-1.0),
     dict(replica_id=-1), dict(pipeline_depth=0), dict(buckets=()),
     dict(buckets=((0, (8, 8)),)), dict(buckets=((2, 8),)),
     dict(buckets=((2, (8, 8)), (2, (8, 8, 8)))), dict(max_wait_ms=-1.0),
     dict(warm_order="2@8x8"), dict(mesh_shape="4x2"),
     dict(mesh_shape=(1, 1, 1)), dict(mesh_shape=(3,)),
     dict(mesh_devices=(0,))],
)
def test_serve_invalid_values_refused_like_jax(kw):
    kw = dict(dict(buckets=((2, (8, 8)),)), **kw)
    with pytest.raises(ValueError):
        jcfg.ServeConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.ServeConfig(**kw)


def test_serve_buckets_normalized_like_jax():
    kw = dict(buckets=[(2, [16, 16]), ("1", (8, 9))], mesh_shape=[],
              warm_order=["2@16x16"])
    j = jcfg.ServeConfig(**{**kw, "warm_order": None})
    t = tcfg.ServeConfig(**{**kw, "warm_order": None})
    assert t.buckets == j.buckets == ((1, (8, 9)), (2, (16, 16)))
    assert t.mesh_shape == j.mesh_shape == ()


@pytest.mark.parametrize(
    "kw",
    [dict(mesh_shape=()), dict(pipeline_depth=1), dict(capture_dir=""),
     dict(artifact_store=""), dict(staged_warmup=False),
     dict(warm_rank_capture=""), dict(tune="off"), dict(metrics_dir="m"),
     dict(slo_p50_ms=10.0), dict(slo_p99_ms=10.0), dict(slo_check_s=1.0),
     dict(slo_profile_dir="p"), dict(replica_id=0), dict(replica_id=3)],
)
def test_serve_values_meaning_the_port_construct(kw):
    """Values that ask for what the port does (single device, depth 1,
    explicitly off, the engine's telemetry and SLO fields) are not
    refused."""
    t = tcfg.ServeConfig(buckets=((2, (8, 8)),), **kw)
    j = jcfg.ServeConfig(buckets=((2, (8, 8)),), **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("verbose", ["none", "brief"])
@pytest.mark.parametrize("track", [None, True, False])
def test_learn_tracking_properties_match_jax(verbose, track):
    kw = dict(verbose=verbose, track_objective=track)
    t, j = tcfg.LearnConfig(**kw), jcfg.LearnConfig(**kw)
    assert t.with_objective == j.with_objective
    assert t.with_obs_metrics == j.with_obs_metrics
    assert t.chunked_driver == j.chunked_driver


@pytest.mark.parametrize(
    "kw",
    [dict(outer_chunk=0), dict(max_recoveries=-1), dict(rho_backoff=0.0),
     dict(rho_backoff=1.5), dict(watchdog_slack=0.0), dict(tune="bogus")],
)
def test_learn_invalid_values_refused_like_jax(kw):
    with pytest.raises(ValueError):
        jcfg.LearnConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.LearnConfig(**kw)


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(outer_chunk=2), "Queue 1 item 9"),
        (dict(donate_state=True), "Queue 1 item 9"),
        (dict(fft_impl="matmul"), "Queue 1 item 9"),
        (dict(tune="auto"), "Queue 1 item 9"),
        # the watchdog runs since the robustness slice: it constructs as
        # JAX's does
        (dict(watchdog=True), None),
    ],
)
def test_learn_unported_fields_raise_naming_roadmap(kw, item):
    j = jcfg.LearnConfig(**kw)  # valid in the JAX package
    if item is None:
        assert dataclasses.asdict(tcfg.LearnConfig(**kw)) == \
            dataclasses.asdict(j)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tcfg.LearnConfig(**kw)


@pytest.mark.parametrize(
    "kw",
    [dict(fused_z_precision="high"), dict(fused_z_precision="default"),
     dict(carry_freq=True), dict(metrics_dir="/nonexistent"),
     dict(verbose="all")],
)
def test_learn_knobs_ported_in_the_learner_slice_construct(kw):
    """K2's precision tiers (all run its float32 body) and the masked
    learner's carry_freq, which the port refused until it learned the 3D,
    4D and hyperspectral problems; the run telemetry's metrics_dir and
    verbose='all' (figures), refused until it wrote the stream."""
    t, j = tcfg.LearnConfig(**kw), jcfg.LearnConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.with_obs_metrics == j.with_obs_metrics


def test_learn_ported_knobs_construct():
    cfg = tcfg.LearnConfig(
        fused_z=True, storage_dtype="bfloat16", d_storage_dtype="bfloat16",
        use_pallas=True, compat_coding="block1", max_recoveries=2,
        fft_pad="fast",
    )
    assert cfg.fused_z and not cfg.chunked_driver


def test_resolve_device_cpu_pins_full_f32():
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert tdevice.resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert tdevice.device_report("cpu") == {"type": "cpu"}


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device()


@pytest.mark.parametrize(
    "kw",
    [dict(tenant=""), dict(tenant="t", weight=0.0), dict(tenant="t", weight=-1),
     dict(tenant="t", quota=0), dict(tenant="t", slo_p50_ms=0.0),
     dict(tenant="t", slo_p99_ms=-1.0), dict(tenant="t", min_psnr_db=0.0),
     dict(tenant="t", deadline_ms=-2.0)],
)
def test_tenant_spec_invalid_values_refused_like_jax(kw):
    with pytest.raises(ValueError) as j:
        jcfg.TenantSpec(**kw)
    with pytest.raises(ValueError) as t:
        tcfg.TenantSpec(**kw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize(
    "kw",
    [dict(replicas=0), dict(max_queue_depth=0), dict(max_queue_s=0.0),
     dict(min_queue_depth=0), dict(max_attempts=0), dict(max_restarts=-1),
     dict(key_window=0), dict(latency_window=0), dict(stall_slack=0.0),
     dict(shed_at=0.2, shed_exit=0.3), dict(shed_at=1.5),
     dict(reject_exit=0.0), dict(degrade_after_s=-1.0),
     dict(degrade_max_it_factor=0.0), dict(degrade_max_it_factor=1.5),
     dict(probe_interval_s=-1.0), dict(slo_p50_ms=0.0),
     dict(deadline_ms=-1.0), dict(hedge_after_ms=0.0),
     dict(hedge_quantile=1.0), dict(hedge_max_frac=1.5),
     dict(metricsd_port=-1), dict(capture_sample=2.0),
     dict(replica_meshes=((2,),)), dict(replicas=2, replica_meshes=("12", None)),
     dict(replicas=1, replica_meshes=((1, 1, 1),)),
     dict(replicas=1, replica_meshes=((0,),)),
     dict(tenants=("t",)),
     dict(tenants=(jcfg.TenantSpec("a"), jcfg.TenantSpec("a")))],
)
def test_fleet_invalid_values_refused_like_jax(kw):
    with pytest.raises(ValueError) as j:
        jcfg.FleetConfig(**kw)
    if "tenants" in kw and not isinstance(kw["tenants"][0], str):
        kw = dict(kw, tenants=tuple(tcfg.TenantSpec(**dataclasses.asdict(s))
                                    for s in kw["tenants"]))
    with pytest.raises(ValueError) as t:
        tcfg.FleetConfig(**kw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(replicas=3, replica_meshes=[None, [2], (2, 2)]),
     dict(tenants=[dict(tenant="a", weight=2.0), dict(tenant="b", quota=4)]),
     dict(max_queue_depth=16, hedge_after_ms=50.0, hedge_quantile=0.9,
          hedge_max_frac=0.1, deadline_ms=100.0, probe_dir="",
          probe_interval_s=0.0, capture_sample=0.5, metricsd_port=0)],
)
def test_fleet_config_normalized_like_jax(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "tenants" in kw:
        jkw["tenants"] = [jcfg.TenantSpec(**r) for r in kw["tenants"]]
        tkw["tenants"] = [tcfg.TenantSpec(**r) for r in kw["tenants"]]
    j, t = jcfg.FleetConfig(**jkw), tcfg.FleetConfig(**tkw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.replica_meshes == j.replica_meshes
    assert type(t.tenants) is type(j.tenants)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_imports_in_port_sources():
    banned = ("jax", "jaxlib", "ccsc_code_iccv2017_tpu")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert not bad, bad


def test_port_imports_without_jax_at_runtime():
    code = (
        "import pkgutil, importlib, sys\n"
        "import ccsc_code_iccv2017_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ccsc_code_iccv2017_torch.apps import inpaint_2d, learn_2d\n"
        "inpaint_2d.build_parser().parse_args(['--data', 'x', '--filters', 'y'])\n"
        "learn_2d.build_parser().parse_args(['--data', 'x', '--fused-z'])\n"
        "from ccsc_code_iccv2017_torch.parallel import consensus\n"
        "from ccsc_code_iccv2017_torch.ops import fused_z\n"
        "import ccsc_code_iccv2017_torch.serve\n"
        "from ccsc_code_iccv2017_torch.serve import bench, engine\n"
        "from ccsc_code_iccv2017_torch.apps import (\n"
        "    deblur_video, demosaic_hyperspectral, poisson_2d,\n"
        "    view_synthesis)\n"
        "from ccsc_code_iccv2017_torch.data import volumes\n"
        "from ccsc_code_iccv2017_torch.apps import (\n"
        "    learn_3d, learn_4d, learn_hyperspectral)\n"
        "from ccsc_code_iccv2017_torch.models import learn_masked\n"
        "for app in (learn_3d, learn_4d, learn_hyperspectral):\n"
        "    app.build_parser().parse_args(['--synthetic'])\n"
        "learn_2d.build_parser().parse_args(['--data', 'x', '--masked'])\n"
        "poisson_2d.build_parser().parse_args(['--data', 'x', '--filters', 'y'])\n"
        "for app in (deblur_video, demosaic_hyperspectral, view_synthesis):\n"
        "    app.build_parser().parse_args(['--synthetic', '--filters', 'y'])\n"
        "volumes.synthetic_video(n=1, side=8, frames=4)\n"
        "from ccsc_code_iccv2017_torch.parallel import streaming\n"
        "from ccsc_code_iccv2017_torch.data import native, whitening\n"
        "from ccsc_code_iccv2017_torch.utils import env\n"
        "env.env_float('CCSC_STREAM_RESIDENT_GB')\n"
        "env.env_flag('CCSC_SERVE_MESH_STRICT')\n"
        "from ccsc_code_iccv2017_torch.utils import (\n"
        "    display, memwatch, obs, perfmodel, profiling, trace)\n"
        "from ccsc_code_iccv2017_torch.analysis import obs_schema\n"
        "from ccsc_code_iccv2017_torch.serve import slo\n"
        "env.env_float('CCSC_OBS_HEARTBEAT_S')\n"
        "env.env_float('CCSC_SLO_CHECK_S')\n"
        "assert perfmodel.detect_chip('cpu') == 'cpu'\n"
        "slo.Histogram.of([1.0, 2.0]).percentile(0.5)\n"
        "from ccsc_code_iccv2017_torch.parallel import local_mesh\n"
        "local_mesh.LocalMesh((2, 2), ('batch', 'freq'), ['cpu'] * 4)\n"
        "assert engine.parse_mesh_shape('2x2') == (2, 2)\n"
        "bench.main.__doc__\n"
        "for app in (learn_3d, learn_4d, learn_hyperspectral):\n"
        "    app.build_parser().parse_args(\n"
        "        ['--synthetic', '--streaming', '--stream-mode', 'paged'])\n"
        "from ccsc_code_iccv2017_torch import supervise\n"
        "from ccsc_code_iccv2017_torch.utils import faults, watchdog\n"
        "from ccsc_code_iccv2017_torch.analysis import ledger\n"
        "from ccsc_code_iccv2017_torch.serve import capture\n"
        "from ccsc_code_iccv2017_torch.tune import store\n"
        "assert watchdog.EXIT_STALL == 87 and faults.nan_iteration() is None\n"
        "assert ledger.knob_digest({}) and capture.payload_sha(\n"
        "    __import__('numpy').zeros(2))\n"
        "supervise.build_parser().parse_args(['--', 'true'])\n"
        "from ccsc_code_iccv2017_torch.serve import (\n"
        "    fleet, metricsd, quality, quality_gate, registry, tenancy)\n"
        "from ccsc_code_iccv2017_torch.apps import serve as serve_app\n"
        "serve_app.build_parser().parse_args(\n"
        "    ['--data', 'x', '--filters', 'y', '--replicas', '2'])\n"
        "assert fleet.RUNGS[0] == 'normal' and tenancy.parse_tenant_spec(\n"
        "    'a:quota=2').quota == 2\n"
        "env.env_float('CCSC_HEDGE_QUANTILE')\n"
        "learn_2d.build_parser().parse_args(\n"
        "    ['--data', 'x', '--watchdog', '--auto-degrade'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccsc_code_iccv2017_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
