"""Find the highest rate a serving cell's engine sustains.

    python3 -m portbench.sweep --workload NAME --rates 8,9,10,11 \
        [--seconds 20] [--seed 1]

One engine, built and warmed as the cell builds it, takes the cell's
open loop at each rate in turn for ``--seconds``. A rate is sustained
when the requests completed in its window keep up with those offered
and the backlog does not grow: the latency of the last
third of its requests is at most 1.25 times that of the first third.
Prints one JSON line a rate, then the knee (the highest sustained rate)
and 80% of it. The cells' rates are fixed from such a sweep; the
benchmark's own runs never search for one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

from . import drivers, run as run_mod
from .systems import serve_engine
from .trace import Tracer


def sustained(recs, t0: float, seconds: float) -> dict:
    """A rate is sustained when every request was answered and the
    backlog did not grow: the median latency of the window's last third
    of requests is within 25% of its first third's. Above the knee the
    queue grows all through the window and the completed rate is the
    engine's capacity."""
    ok = [r for r in recs if r["result"] is not None]
    end = t0 + seconds
    lat = [1e3 * (r["done"] - r["due"]) for r in ok]
    third = max(1, len(lat) // 3)
    first, last = statistics.median(lat[:third]), statistics.median(
        lat[-third:])
    done_in = sum(r["done"] <= end for r in ok)
    return {"offered": len(recs), "served_rps": done_in / seconds,
            "p50_ms": statistics.median(lat), "first_third_ms": first,
            "last_third_ms": last,
            "ok": len(ok) == len(recs) and last <= 1.25 * first}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    bench = run_mod.load_json(run_mod.ROOT + "/BENCHMARK.json")
    cell, config, traffic = run_mod.resolve(bench, args.workload,
                                            run_mod.ROOT)
    run_mod.clean_env(config)
    print("knobs " + json.dumps({"card": run_mod.card_line()}), flush=True)
    ctx = run_mod.Ctx(cell, config, traffic, args.seed, args.seconds,
                      Tracer(False), "cuda", time.perf_counter())
    engine, submit, _, _ = serve_engine.start(ctx)
    try:
        knee = None
        for rate in (float(r) for r in args.rates.split(",")):
            tr = dict(traffic, rate_rps=rate)
            t0, recs = drivers.open_loop(tr, submit, args.seed, args.seconds,
                                         ctx.tracer, 0.0)
            rec = dict(rate_rps=rate, **sustained(recs, t0, args.seconds))
            print(json.dumps(rec), flush=True)
            if rec["ok"]:
                knee = rate
        print(json.dumps({"knee_rps": knee,
                          "cell_rate_rps": None if knee is None
                          else 0.8 * knee}), flush=True)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
