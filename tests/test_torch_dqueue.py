"""The port's durable file-lease queue (``ccsc_code_iccv2017_torch.
serve.dqueue``) held to the JAX package's ``serve.dqueue``:

- the lease-protocol contracts of the JAX package's own queue tests,
  run against the port's module: one winner per concurrent claim,
  torn files read as absent, clock-skew-bounded expiry, reaper vs late
  delivery fencing, epoch fencing, the attempt budget, spent keys,
  the claim window, first-wins results, leave/seal/drained, durable
  deadline and cancel resolutions;
- the on-disk format is shared: a queue the JAX module submits is
  claimed and completed by the port's and read back by JAX (result and
  spent marker), and the reverse;
- the same operation script on both modules leaves the same tree of
  file names and the same records, apart from time, host and epoch
  fields.

Pure filesystem tests: no engine, no device.
"""
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_torch.serve import dqueue as tdq
from ccsc_code_iccv2017_torch.serve.capture import payload_sha
from ccsc_code_iccv2017_tpu.serve import dqueue as jdq


def _x(seed=0, shape=(6, 6)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _q(tmp_path, host, mod=tdq, **kw):
    ev = []
    kw.setdefault("ttl_s", 0.5)
    kw.setdefault("skew_s", 0.1)
    q = mod.DurableQueue(
        str(tmp_path), host=host,
        emit=lambda t, **f: ev.append(dict(f, type=t)), **kw,
    )
    q.events = ev
    return q


def test_submit_claim_complete_roundtrip(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    x = _x(1)
    client.submit("k1", x, mask=None, x_orig=x)
    items = a.claim(limit=4)
    assert len(items) == 1
    it = items[0]
    assert it["key"] == "k1" and it["attempts"] == 1
    assert np.array_equal(a.load_array(it["b"]), x)
    assert a.complete(
        it, x * 2, psnr=31.5, latency_ms=4.0, bucket="2@6x6", iters=3
    )
    res = client.result("k1")
    assert res["status"] == "ok"
    assert res["host"] == "A" and res["attempts"] == 1
    assert np.array_equal(client.load_array(res["recon"]), x * 2)
    # content digest pairs with the capture oracle's convention
    assert res["digest"] == payload_sha(np.ascontiguousarray(x * 2))
    assert client.spent("k1")
    st = client.stats()
    assert st["queued"] == 0 and st["leased"] == 0


def test_concurrent_claim_exactly_one_winner(tmp_path):
    client = _q(tmp_path, "client")
    hosts = [_q(tmp_path, f"H{i}") for i in range(4)]
    for h in hosts:
        h.join()
    client.submit("solo", _x(2))
    won = []
    barrier = threading.Barrier(len(hosts))

    def race(h):
        barrier.wait()
        won.extend(h.claim(limit=4))

    ts = [threading.Thread(target=race, args=(h,)) for h in hosts]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(won) == 1  # the rename has one winner, no lock file
    assert won[0]["key"] == "solo"


def test_torn_request_and_lease_files_read_as_absent(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    with open(tmp_path / "queue" / "000-torn.json", "w") as f:
        f.write('{"key": "tor')
    client.submit("good", _x(3))
    items = a.claim(limit=4)
    assert [i["key"] for i in items] == ["good"]
    assert not os.path.exists(tmp_path / "queue" / "000-torn.json")
    lease = tmp_path / "leases" / "A" / "zzz-torn.json"
    with open(lease, "w") as f:
        f.write('{"key": "half')
    assert a.reap() == []  # young torn lease: left alone
    old = time.time() - 10.0
    os.utime(lease, (old, old))
    a.reap()
    assert not lease.exists()
    with open(tmp_path / "hosts" / "B.json", "w") as f:
        f.write('{"host": "B", "epo')
    assert "B" not in a._host_table()


def test_expiry_is_clock_skew_bounded(tmp_path):
    client = _q(tmp_path, "client", ttl_s=1.0, skew_s=0.5)
    a = _q(tmp_path, "A", ttl_s=1.0, skew_s=0.5)
    b = _q(tmp_path, "B", ttl_s=1.0, skew_s=0.5)
    a.join()
    b.join()
    client.submit("k", _x(4))
    assert a.claim()
    hb_path = a._host_path("A")

    def stamp(dt):
        with open(hb_path) as f:
            rec = json.load(f)
        rec["t"] = time.time() + dt
        with open(hb_path, "w") as f:
            json.dump(rec, f)

    stamp(+3.0)  # owner's clock ahead of ours: alive
    assert b.reap() == []
    stamp(-1.2)  # older than ttl, within the skew allowance: alive
    assert b.reap() == []
    stamp(-1.8)  # older than ttl + skew: dead whoever's clock is right
    reaped = b.reap()
    assert [r["key"] for r in reaped] == ["k"]
    it = b.claim()[0]
    assert it["attempts"] == 2


def test_reaper_vs_late_delivery_fencing(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A", ttl_s=0.2, skew_s=0.05)
    b = _q(tmp_path, "B", ttl_s=0.2, skew_s=0.05)
    a.join()
    b.join()
    x = _x(5)
    client.submit("k", x, trace_id="t1", root_span="r1")
    it_a = a.claim()[0]
    time.sleep(0.4)  # A's heartbeat goes stale (it is wedged)
    b.heartbeat()
    assert [r["key"] for r in b.reap()] == ["k"]
    it_b = b.claim()[0]
    assert b.complete(it_b, x * 3, latency_ms=1.0)
    assert not a.complete(it_a, x * 3)  # fenced: B's result stands
    res = client.result("k")
    assert res["host"] == "B" and res["attempts"] == 2
    sup = [e for e in a.events if e["type"] == "dqueue_suppressed"]
    assert sup and sup[-1]["key"] == "k"
    req_spans = [
        e for e in b.events
        if e["type"] in ("span_start", "span_end")
        and e.get("trace_id") == "t1"
    ]
    assert len(req_spans) == 2  # one retrospective start+end pair
    assert req_spans[-1]["status"] == "requeued"


def test_epoch_fencing_refuses_previous_incarnation(tmp_path):
    client = _q(tmp_path, "client")
    a1 = _q(tmp_path, "A")
    a1.join()
    client.submit("k", _x(6))
    it = a1.claim()[0]
    a2 = _q(tmp_path, "A")
    assert a2.join() == a1.epoch + 1
    assert a2.reap()  # epoch rule: old-epoch lease requeued at once
    assert not a1.complete(it, _x(6))  # stale epoch: suppressed


def test_attempt_budget_writes_explicit_error(tmp_path):
    client = _q(tmp_path, "client", max_attempts=2)
    client.submit("doomed", _x(7))
    b = _q(tmp_path, "B", ttl_s=0.1, skew_s=0.0)
    b.join()
    for _ in range(2):
        assert b.claim()
        time.sleep(0.25)
        r = _q(tmp_path, "R", ttl_s=0.1, skew_s=0.0)
        r.join()
        r.reap()
    res = client.result("doomed")
    assert res is not None and res["status"] == "error"
    assert res["attempts"] == 2
    assert client.spent("doomed")
    with pytest.raises(ValueError):
        client.submit("doomed", _x(7))


def test_requeued_copy_of_spent_key_dropped_at_claim(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    x = _x(8)
    client.submit("k", x)
    it = a.claim()[0]
    assert a.complete(it, x)
    stale = dict(it)
    stale["attempts"] = 1
    with open(tmp_path / "queue" / it["name"], "w") as f:
        json.dump(stale, f)
    assert a.claim(limit=4) == []
    assert not os.path.exists(tmp_path / "queue" / it["name"])


def test_reaper_spares_unstamped_fresh_claim(tmp_path):
    client = _q(tmp_path, "client", ttl_s=0.3, skew_s=0.1)
    a = _q(tmp_path, "A", ttl_s=0.3, skew_s=0.1)
    b = _q(tmp_path, "B", ttl_s=0.3, skew_s=0.1)
    a.join()
    b.join()
    name = client.submit("k", _x(12))
    os.rename(
        tmp_path / "queue" / name, tmp_path / "leases" / "A" / name
    )
    assert b.reap() == []  # fresh unstamped claim: hands off
    st = client.stats()
    assert st["leased"] == 1 and st["queued"] == 0
    old = time.time() - 5.0
    os.utime(tmp_path / "leases" / "A" / name, (old, old))
    assert [r["key"] for r in b.reap()] == ["k"]
    assert client.stats()["queued"] == 1


def test_result_record_is_first_wins(tmp_path):
    p = str(tmp_path / "r.json")
    assert tdq._publish_json(p, {"status": "ok", "who": "winner"})
    assert not tdq._publish_json(p, {"status": "error", "who": "loser"})
    with open(p) as f:
        assert json.load(f)["who"] == "winner"
    client = _q(tmp_path, "client", max_attempts=1)
    a = _q(tmp_path, "A", ttl_s=0.1, skew_s=0.0)
    a.join()
    client.submit("k", _x(13))
    it = a.claim()[0]
    assert a.complete(it, _x(13) * 2)
    assert not a._requeue(dict(it), str(tmp_path / "nope.json"), "x")
    assert client.result("k")["status"] == "ok"


def test_leave_releases_leases_and_seal_drained(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    client.submit("k1", _x(9))
    client.submit("k2", _x(10))
    assert len(a.claim(limit=4)) == 2
    assert not client.drained
    assert a.leave() == 2
    st = client.stats()
    assert st["queued"] == 2 and st["leased"] == 0
    assert st["hosts"]["A"]["status"] == "left"
    assert not client.sealed
    client.seal()
    assert client.sealed
    b = _q(tmp_path, "B")
    b.join()
    for it in b.claim(limit=4):
        assert b.complete(it, _x(11))
    assert client.drained
    assert "/" not in tdq.safe_key("../../etc/passwd")
    assert tdq.safe_key("../../etc/passwd") == jdq.safe_key(
        "../../etc/passwd")


def test_claim_of_expired_item_writes_durable_deadline_result(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    client.submit("late", _x(3), deadline=time.time() + 0.05)
    client.submit("fine", _x(4))
    time.sleep(0.1)
    assert [it["key"] for it in a.claim(limit=4)] == ["fine"]
    res = client.result("late")
    assert res is not None and res["status"] == "deadline"
    assert client.spent("late")
    st = client.stats()
    assert st["queued"] == 0 and st["leased"] == 1
    assert any(
        e["type"] == "deadline_exceeded" and e.get("where") == "claim"
        for e in a.events
    )


def test_cancel_writes_durable_marker_and_claim_refuses(tmp_path):
    client = _q(tmp_path, "client")
    a = _q(tmp_path, "A")
    a.join()
    client.submit("bail", _x(5))
    assert client.cancel("bail") is True
    res = client.result("bail")
    assert res is not None and res["status"] == "cancelled"
    assert client.spent("bail")
    assert a.claim(limit=4) == []
    client.submit("served", _x(6))
    (it,) = a.claim(limit=4)
    assert a.complete(it, _x(6) * 2)
    assert client.cancel("served") is False
    assert client.result("served")["status"] == "ok"


# ------------------------------------------ the shared on-disk format


@pytest.mark.parametrize("writer, drainer", [(jdq, tdq), (tdq, jdq)],
                         ids=["jax_submits_port_drains",
                              "port_submits_jax_drains"])
def test_queue_is_drained_across_packages(tmp_path, writer, drainer):
    """One package's frontend submits; the other's host claims,
    completes, fails and reaps; the submitter reads every resolution,
    the payload bytes and the spent markers back."""
    client = _q(tmp_path, "client", mod=writer)
    host = _q(tmp_path, "H", mod=drainer)
    host.join()
    xs = [_x(20 + i) for i in range(3)]
    for i, x in enumerate(xs):
        client.submit(f"k{i}", x, mask=(x > 0.5).astype(np.float32),
                      x_orig=x, trace_id=f"t{i}", root_span=f"r{i}")
    client.seal()
    items = host.claim(limit=8)
    assert [it["key"] for it in items] == ["k0", "k1", "k2"]
    assert np.array_equal(host.load_array(items[0]["b"]), xs[0])
    assert np.array_equal(host.load_array(items[1]["mask"]),
                          (xs[1] > 0.5).astype(np.float32))
    assert host.complete(items[0], xs[0] * 2, psnr=30.0, latency_ms=2.0,
                         bucket="2@6x6", iters=5)
    host.fail(items[1], "boom")
    assert host.release(items[2])
    (again,) = host.claim(limit=8)
    assert again["attempts"] == 2
    assert host.complete(again, xs[2] * 3)
    assert host.drained and host.sealed
    r0 = client.result("k0")
    assert r0["status"] == "ok" and r0["host"] == "H"
    assert r0["digest"] == payload_sha(np.ascontiguousarray(xs[0] * 2))
    assert np.array_equal(client.load_array(r0["recon"]), xs[0] * 2)
    assert client.result("k1")["status"] == "error"
    assert client.result("k2")["attempts"] == 2
    assert all(client.spent(f"k{i}") for i in range(3))
    with pytest.raises(ValueError):
        client.submit("k0", xs[0])
    assert client.drained
    host.leave()
    assert client.stats()["hosts"]["H"]["status"] == "left"


_VOLATILE = {"t", "t_submit", "lease_t", "epoch", "lease_epoch", "host",
             "client", "by", "from_host", "by_host", "t_spent", "t_seal",
             "t_join", "t_done", "latency_ms"}
_STAMP = re.compile(r"^\d{15}-")


def _tree(root):
    """Every file under ``root`` (names with the submit-time prefix
    stripped) and each JSON record without its time, host and epoch
    fields."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            rel = rel.replace(os.sep, "/")
            parts = rel.split("/")
            parts = [_STAMP.sub("T-", p) for p in parts]
            parts = ["HOST" if p in ("hj", "ht") else p for p in parts]
            parts = [re.sub(r"^h[jt]\.json$", "HOST.json", p)
                     for p in parts]
            key = "/".join(parts)
            with open(os.path.join(d, f), "rb") as fh:
                raw = fh.read()
            try:  # records (*.json and the SEALED marker) compare scrubbed
                out[key] = _scrub(json.loads(raw.decode("utf-8")))
            except (UnicodeDecodeError, ValueError):
                out[key] = raw  # payload arrays compare byte for byte
    return out


def _scrub(v):
    if isinstance(v, dict):
        return {k: _scrub(x) for k, x in sorted(v.items())
                if k not in _VOLATILE}
    if isinstance(v, list):
        return [_scrub(x) for x in v]
    if isinstance(v, str):
        return _STAMP.sub("T-", v)
    return v


def _script(mod, root, host):
    client = _q(root, "client", mod=mod)
    h = _q(root, host, mod=mod)
    h.join()
    x = _x(30)
    client.submit("a", x, mask=(x > 0.3).astype(np.float32), x_orig=x,
                  trace_id="ta", root_span="ra")
    client.submit("b", _x(31))
    client.submit("c", _x(32))
    client.submit("d", _x(33))
    its = h.claim(limit=3)
    h.heartbeat(leased=3, served=0)
    h.complete(its[0], x * 2, psnr=20.5, latency_ms=1.0, bucket="2@6x6",
               iters=4)
    h.fail(its[1], "bad request")
    h.release(its[2])
    client.cancel("d")
    client.seal()
    (again,) = h.claim(limit=4)
    h.complete(again, _x(32) + 1)
    h.leave()


def test_same_script_leaves_the_same_tree(tmp_path):
    _script(jdq, tmp_path / "j", "hj")
    _script(tdq, tmp_path / "t", "ht")
    tj, tt = _tree(str(tmp_path / "j")), _tree(str(tmp_path / "t"))
    assert sorted(tt) == sorted(tj)
    for k in tj:
        assert tt[k] == tj[k], k
