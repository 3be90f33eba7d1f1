"""Every learner app's ``--streaming`` (``learn_2d``, ``learn_3d``,
``learn_4d``, ``learn_hyperspectral``) against the JAX app's on the same
arguments, at a tiny size on the CPU, and the streaming arm of the
port's learner dispatch (``apps/_common.py::dispatch_learn``).

Each port app starts from the JAX init of ``--seed`` (its learner's
``init_state`` replaced, as in tests/test_torch_learn_apps.py).
Tolerances: objective traces rtol 1e-4, filters within 1e-4 of their
scale, reconstructions within 1e-4 of the data's scale. The
hyperspectral app's streamed Dz carries the smooth_init offset back, so
its comparison covers the offset's restoration.
"""
import numpy as np
import pytest
import scipy.io
import torch

from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_torch.apps import _common
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.data import volumes as tvolumes
from ccsc_code_iccv2017_torch.parallel import streaming

from test_torch_learn import _write_pngs
from test_torch_learn_apps import APP_ARGV, _apps, _close, _use_jax_inits

STREAM_ARGV = dict(APP_ARGV, learn_2d=(
    ["--filters", "4", "--support", "5", "--blocks", "2", "--max-it", "2",
     "--max-it-d", "2", "--max-it-z", "2", "--tol", "0"], "2d"))


def _argv(name, tmp_path):
    argv, layout = STREAM_ARGV[name]
    if name == "learn_2d":
        data = str(tmp_path / "imgs")
        _write_pngs(data, n=4, side=16)
        argv = ["--data", data] + argv
    return argv + ["--verbose", "none", "--seed", "3"], layout


@pytest.mark.parametrize("mode", ["paged", "device"])
@pytest.mark.parametrize("name", list(STREAM_ARGV))
def test_streaming_app_matches_the_jax_app(monkeypatch, tmp_path, name, mode):
    argv, layout = _argv(name, tmp_path)
    argv = argv + ["--streaming", "--stream-mode", mode]
    japp, tapp = _apps(name)
    jout, tout = str(tmp_path / "j.mat"), str(tmp_path / "t.mat")
    jr = japp.main(argv + ["--out", jout])
    _use_jax_inits(monkeypatch)
    tr = tapp.main(argv + ["--out", tout, "--device", "cpu"])
    assert tr.trace["algorithm"] == "consensus_streaming"
    assert tr.trace["stream_mode"] == mode
    for k in ("obj_vals_d", "obj_vals_z"):
        assert len(tr.trace[k]) == len(jr.trace[k])
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=1e-4)
    _close(tr.d.numpy(), jr.d)
    # over the data's scale: two steps of a tiny problem leave the 3D and
    # 4D reconstructions orders of magnitude below the data
    Dz, jDz = tr.Dz.numpy(), np.asarray(jr.Dz)
    scale = (np.abs(jDz).max() if name == "learn_2d" else
             np.abs(tapp.load_data(tapp.build_parser().parse_args(argv))).max())
    assert Dz.shape == jDz.shape
    assert np.abs(Dz - jDz).max() <= 1e-4 * scale
    load = getattr(jio, "load_filters_2d" if layout == "2d"
                   else f"load_filters_{layout}")
    np.testing.assert_array_equal(load(tout), tr.d.numpy())
    np.testing.assert_array_equal(jio.load_dz(tout, layout), Dz)
    assert scipy.io.loadmat(tout)["d"].shape == \
        scipy.io.loadmat(jout)["d"].shape


@pytest.mark.parametrize("name, flags, why", [
    ("learn_3d", ["--stream-mode", "auto"], "--stream-mode requires "
     "--streaming"),
    ("learn_hyperspectral", ["--streaming", "--carry-freq"],
     "--streaming does not combine with --carry-freq"),
    ("learn_hyperspectral", ["--streaming", "--init", "{bank}"],
     "--streaming does not combine with --init"),
    ("learn_2d", ["--streaming", "--init-filters", "{bank}"],
     "--streaming does not combine with --init-filters"),
])
def test_streaming_refusals_match_the_jax_app(tmp_path, name, flags, why):
    argv, layout = _argv(name, tmp_path)
    bank = str(tmp_path / "bank.mat")  # the JAX apps read it first
    shape = (4, 5, 5) if layout == "2d" else (3, 3, 3, 3)
    jio.save_filters(bank, np.zeros(shape, np.float32), {}, layout=layout)
    flags = [f.format(bank=bank) for f in flags]
    for app in _apps(name):
        with pytest.raises(SystemExit, match=why):
            app.main(argv + flags + ["--out", str(tmp_path / "o.mat")]
                     + (["--device", "cpu"] if "torch" in app.__name__
                        else []))


def test_stream_mode_without_streaming_is_refused_by_every_app(tmp_path):
    """The JAX dispatch's contract; the JAX hyperspectral app's masked
    arm skips it and ignores --stream-mode, the port refuses there too."""
    for name in STREAM_ARGV:
        argv, _ = _argv(name, tmp_path)
        with pytest.raises(SystemExit, match="requires --streaming"):
            _apps(name)[1].main(argv + ["--stream-mode", "kern", "--device",
                                        "cpu", "--out", "/nonexistent"])


def test_streaming_blocks_take_the_largest_divisor(monkeypatch, tmp_path):
    """3 cubes with --streaming-blocks 2: one block of 3, as JAX."""
    argv = ["--synthetic", "--limit", "3", "--bands", "3", "--filters", "3",
            "--support", "3", "--max-it", "1", "--streaming",
            "--streaming-blocks", "2", "--verbose", "none"]
    japp, tapp = _apps("learn_hyperspectral")
    jr = japp.main(argv + ["--out", str(tmp_path / "j.mat")])
    _use_jax_inits(monkeypatch)
    tr = tapp.main(argv + ["--out", str(tmp_path / "t.mat"),
                           "--device", "cpu"])
    assert tuple(tr.z.shape) == np.asarray(jr.z).shape
    assert tr.z.shape[:2] == (1, 3)


def test_dispatch_restores_the_offset_in_dz():
    """dispatch_learn(streaming=True, streaming_offset=sm) codes b - sm
    and returns Dz + sm (tests/test_streaming.py's check)."""
    b = tvolumes.synthetic_hyperspectral(n=2, bands=3, side=12)
    sm = np.full_like(b, 0.25)
    geom = ProblemGeom((3, 3), 4, (3,))
    cfg = LearnConfig(max_it=1, max_it_d=2, max_it_z=2, num_blocks=2,
                      verbose="none")
    res = _common.dispatch_learn(b, geom, cfg, 0, "cpu", streaming=True,
                                 streaming_blocks=2, streaming_offset=sm)
    raw = streaming.learn_streaming(
        b - sm, geom, cfg, generator=torch.Generator().manual_seed(0),
        device="cpu",
    )
    np.testing.assert_allclose(res.Dz.numpy(), raw.Dz.numpy() + sm,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(SystemExit, match="does not combine with init_d"):
        _common.dispatch_learn(b, geom, cfg, 0, "cpu", streaming=True,
                               init_d=np.zeros((4, 3, 3, 3), np.float32))
