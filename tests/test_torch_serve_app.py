"""The port's serving CLI (``python -m ccsc_code_iccv2017_torch.apps.serve``)
against the JAX package's ``apps/serve.py`` ``main()`` on the same
images and bank, on the CPU: the engine path and the fleet path
(``--replicas 2``) write the same reconstructions (16-bit PNGs within
REC_TOL = 1e-4 plus one quantization step) and serve the same number
of requests; ``--federate`` drains a durable queue as one federated
host, ``--min/--max-replicas`` serve under the capacity controller and
refuse the JAX CLI's bad pairs with its messages, and the compile
cache, artifact store and staged warmup are refused, naming ROADMAP.md
Queue 1 item 11's second half.

The bank is k=4 5x5 and the images 20x20 in a 24x24 two-slot bucket,
max_it 5, written as a MATLAB-layout ``.mat`` stack
(``scipy.io.savemat``, read by ``data.images.load_image_list``).
"""
import os

import numpy as np
import pytest
import scipy.io
from PIL import Image

from ccsc_code_iccv2017_tpu.apps import serve as japp
from ccsc_code_iccv2017_torch.apps import serve as tapp

REC_TOL = 1e-4


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_app")
    r = np.random.default_rng(0)
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    scipy.io.savemat(str(root / "bank.mat"), {"d": np.transpose(d, (1, 2, 0))})
    imgs = r.random((3, 20, 20)).astype(np.float32)
    scipy.io.savemat(str(root / "imgs.mat"),
                     {"b": np.transpose(imgs, (1, 2, 0))})
    return root


def _argv(root, out, *extra):
    return ["--filters", str(root / "bank.mat"), "--data",
            str(root / "imgs.mat"), "--mat-layout", "matlab",
            "--bucket", "24:2", "--max-it", "5", "--out-dir", str(out),
            *extra]


def _pngs(out):
    return {f: np.asarray(Image.open(os.path.join(out, f)), np.float64)
            / 65535.0 for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("extra", [(), ("--replicas", "2")],
                         ids=["engine", "replicas2"])
def test_serve_main_matches_jax_main(fixtures, tmp_path, capsys, extra):
    jout, tout = tmp_path / "j", tmp_path / "t"
    n_j = japp.main(_argv(fixtures, jout, *extra))
    jtext = capsys.readouterr().out
    n_t = tapp.main(_argv(fixtures, tout, *extra, "--device", "cpu"))
    ttext = capsys.readouterr().out
    assert n_t == n_j == 3
    jp, tp = _pngs(str(jout)), _pngs(str(tout))
    assert sorted(tp) == sorted(jp) == [f"recon_img{i}.png"
                                        for i in range(3)]
    for name in jp:
        assert np.abs(tp[name] - jp[name]).max() <= REC_TOL + 1.0 / 65535
    # the same per-request lines (iterations, bucket; PSNR to 0.01 dB)
    def rows(text):
        return [ln.split(", latency")[0] for ln in text.splitlines()
                if ln.startswith("  img")]

    assert rows(ttext) == rows(jtext)
    if extra:
        assert "fleet ready" in ttext and "over 2 replica(s)" in ttext
    else:
        assert "engine ready" in ttext and "dispatch(es)" in ttext


def _bank_argv(root, *extra):
    return ["--filters", str(root / "bank.mat"), "--bucket", "24:2",
            "--max-it", "5", *extra, "--device", "cpu"]


def _submit_sealed(qdir, root, n=3):
    """A port frontend enqueues the fixture's first ``n`` images with
    the CLI's own request protocol and seals the queue."""
    from ccsc_code_iccv2017_torch.serve.federation import FederatedFrontend

    imgs = np.transpose(scipy.io.loadmat(str(root / "imgs.mat"))["b"],
                        (2, 0, 1)).astype(np.float32)
    r = np.random.default_rng(1)
    fe = FederatedFrontend(str(qdir), client="fe", verbose="none")
    futs = []
    for i in range(n):
        m = (r.random(imgs[i].shape) < 0.5).astype(np.float32)
        futs.append(fe.submit(imgs[i] * m, mask=m, x_orig=imgs[i],
                              key=f"img{i}"))
    fe.seal()
    return fe, futs


@pytest.mark.parametrize("how", ["dir", "env"])
def test_federate_drains_a_sealed_queue(fixtures, tmp_path, capsys,
                                        monkeypatch, how):
    """``--federate DIR`` (or bare ``--federate`` with CCSC_DQUEUE_DIR)
    runs the CLI as one federated host: it drains the sealed queue,
    every frontend future resolves from its durable result, and the
    process returns the count it served."""
    qdir = tmp_path / "q"
    fe, futs = _submit_sealed(qdir, fixtures)
    try:
        if how == "env":
            monkeypatch.setenv("CCSC_DQUEUE_DIR", str(qdir))
            argv = _bank_argv(fixtures, "--federate")
        else:
            argv = _bank_argv(fixtures, "--federate", str(qdir))
        assert tapp.main(argv) == 3
        res = [f.result(timeout=60) for f in futs]
    finally:
        fe.close()
    out = capsys.readouterr().out
    assert "draining until sealed" in out and "served 3 request(s)" in out
    assert all(r.attempts == 1 and np.isfinite(r.recon).all()
               for r in res)
    assert len({r.host for r in res}) == 1


def test_federate_without_dir_needs_the_env(fixtures, monkeypatch):
    monkeypatch.delenv("CCSC_DQUEUE_DIR", raising=False)
    with pytest.raises(SystemExit, match="CCSC_DQUEUE_DIR"):
        tapp.main(_bank_argv(fixtures, "--federate"))


def test_host_id_names_the_lease_dir(fixtures, tmp_path, capsys):
    qdir = tmp_path / "q"
    fe, futs = _submit_sealed(qdir, fixtures, n=2)
    try:
        assert tapp.main(_bank_argv(fixtures, "--federate", str(qdir),
                                    "--host-id", "edge-7")) == 2
        assert {f.result(timeout=60).host for f in futs} == {"edge-7"}
    finally:
        fe.close()
    assert os.path.isdir(qdir / "leases" / "edge-7")
    with open(qdir / "hosts" / "edge-7.json") as f:
        import json

        assert json.load(f)["status"] == "left"
    assert "federated host edge-7 (epoch 1)" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ("--max-replicas", "2"), ("--min-replicas", "1"),
    ("--min-replicas", "0", "--max-replicas", "2"),
    ("--min-replicas", "3", "--max-replicas", "2"),
    ("--federate", "Q", "--min-replicas", "1", "--max-replicas", "2"),
    ("--federate", "Q", "--publish-bank", "b", "--bank-registry", "R"),
], ids=["max_only", "min_only", "min_zero", "min_above_max",
        "with_federate", "publish_with_federate"])
def test_controller_and_federate_refusals_match_jax(fixtures, tmp_path,
                                                    flags):
    flags = tuple(str(tmp_path / f) if f in ("Q", "R") else f
                  for f in flags)
    argv = (["--filters", str(fixtures / "bank.mat"), *flags]
            if "--federate" in flags
            else _argv(fixtures, tmp_path / "o", *flags))
    with pytest.raises(SystemExit) as j:
        japp.main(argv)
    with pytest.raises(SystemExit) as t:
        tapp.main([*argv, "--device", "cpu"])
    assert str(t.value) == str(j.value)


def test_min_max_replicas_serve_under_the_controller(fixtures, tmp_path,
                                                     capsys):
    n = tapp.main(_argv(fixtures, tmp_path / "o", "--min-replicas", "1",
                        "--max-replicas", "2", "--device", "cpu"))
    out = capsys.readouterr().out
    assert n == 3
    assert "capacity controller active (1..2 replicas" in out
    assert "fleet ready" in out


@pytest.mark.parametrize("flags", [
    ("--compile-cache", "cc"), ("--artifact-store", "a"),
    ("--staged-warmup",),
], ids=lambda f: f[0].lstrip("-"))
def test_second_half_serve_fields_are_refused(fixtures, tmp_path, flags):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 11, second half"):
        tapp.main(_argv(fixtures, tmp_path / "o", *flags, "--device",
                        "cpu"))


def test_serve_app_defaults_to_the_card(fixtures, tmp_path):
    """No ``--device``: the app asks for the card, and without one it
    raises instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert tapp.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.main(_argv(fixtures, tmp_path / "o", "--replicas", "2"))


def test_tenants_and_registry_banks_through_the_fleet(fixtures, tmp_path,
                                                      capsys):
    """``--bank-registry``/``--bank-id``/``--publish-bank``,
    ``--tenant``/``--request-tenant`` and ``--metricsd-snapshot`` on the
    fleet path: the registry bank serves, the request stream rides the
    declared tenant and the snapshot counts the served requests."""
    from ccsc_code_iccv2017_torch.serve.registry import BankRegistry
    from ccsc_code_iccv2017_torch.utils.io_mat import load_filters_2d

    d = load_filters_2d(str(fixtures / "bank.mat"))
    reg = BankRegistry(str(tmp_path / "reg"))
    reg.publish("main", d)
    reg.publish("alt", d[::-1].copy(), tenant="t1")
    reg.close()
    snap = str(tmp_path / "m.prom")
    n = tapp.main([
        "--bank-registry", str(tmp_path / "reg"), "--bank-id", "main",
        "--publish-bank", "alt", "--tenant", "t1:bank=alt,quota=8",
        "--request-tenant", "t1", "--data", str(fixtures / "imgs.mat"),
        "--mat-layout", "matlab", "--bucket", "24:2", "--max-it", "3",
        "--metricsd-snapshot", snap, "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert n == 3
    assert "serving registry bank main @" in out
    assert "published alt @" in out and "tenant t1" in out
    with open(snap) as f:
        text = f.read()
    assert "ccsc_requests_total 3" in text
    assert 'ccsc_tenant_requests_total{tenant="t1"} 3' in text
