"""Regression gate over the durable perf ledger (analysis.ledger) — the
port's counterpart of the JAX package's ``scripts/perf_gate.py``, with
the same flags, verdicts and exit codes:

    python -m ccsc_code_iccv2017_torch.analysis.perf_gate
                                      # gate: newest record per key vs
                                      # its prior history
    python -m ccsc_code_iccv2017_torch.analysis.perf_gate --record R.json
                                      # gate one external record (CI:
                                      # the run you just measured)
                                      # without appending it
    python -m ccsc_code_iccv2017_torch.analysis.perf_gate --list
                                      # per-key history
    python -m ccsc_code_iccv2017_torch.analysis.perf_gate --list \
        --kind replay                 # one run family
    python -m ccsc_code_iccv2017_torch.analysis.perf_gate --json
                                      # machine-readable

Exit status: 0 = no regression (keys with fewer than
CCSC_PERF_GATE_MIN_HISTORY prior records pass trivially and are
reported as skipped — a young ledger starts gating as history
accrues), 1 = at least one key's judged record fell below its
robust band (median − max(CCSC_PERF_GATE_MAD · 1.4826 · MAD,
CCSC_PERF_GATE_FRAC · median) of the key's prior history), 2 = a
usage error (an unreadable or malformed --record, or --seed-from).

The ledger path comes from --ledger, else CCSC_PERF_LEDGER, else the
standard resolution (analysis.ledger.default_ledger_path). Record
kinds judged: learn | bench | serve | solve | replay (traffic-replay
sessions, serve.replay — requests/sec of a captured stream
re-served); --kind restricts gating/listing to one family.

``--seed-from`` parses and exits 2: the seeders read the JAX package's
bench artifacts, which hold no number measured by this port, so they
are not ported (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import ledger as ledger_mod


def _fmt_verdict(v) -> str:
    if v.get("skipped"):
        return (
            f"perf-gate: SKIP  {v['key']}  "
            f"({v.get('reason', 'insufficient history')}, "
            f"n={v.get('n_history', 0)})"
        )
    tag = "OK  " if v["ok"] else "REGRESSION"
    rel = v.get("ratio_vs_median")
    rel_s = f"{100 * (rel - 1):+.1f}% vs median" if rel else "n/a"
    return (
        f"perf-gate: {tag}  {v['key']}  "
        f"{v['value']:.6g} {v.get('unit') or ''} ({rel_s}, "
        f"median {v['median']:.6g}, band lo {v['lo']:.6g}, "
        f"n={v['n_history']})"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--ledger", default=None,
        help="ledger JSONL path (default: CCSC_PERF_LEDGER, else "
        "$CCSC_COMPILE_CACHE/ccsc_perf_ledger.jsonl, else the "
        "checkout's perf_ledger.jsonl)",
    )
    ap.add_argument(
        "--seed-from", nargs="*", default=None, metavar="PATH",
        help="seed the ledger from the JAX package's bench artifacts "
        "(not ported: exits 2)",
    )
    ap.add_argument(
        "--record", default=None, metavar="REC.json",
        help="gate ONE external record (normalized fields: chip, "
        "kind, value, unit[, workload, shape_key, knobs]) against "
        "the ledger history for its key, without appending",
    )
    ap.add_argument(
        "--mad", type=float, default=None,
        help="band half-width in MAD-sigmas (CCSC_PERF_GATE_MAD, "
        "default 3.0)",
    )
    ap.add_argument(
        "--frac", type=float, default=None,
        help="minimum relative drop treated as regression "
        "(CCSC_PERF_GATE_FRAC, default 0.25)",
    )
    ap.add_argument(
        "--min-history", type=int, default=None,
        help="prior records a key needs before it is judged "
        "(CCSC_PERF_GATE_MIN_HISTORY, default 3)",
    )
    ap.add_argument(
        "--list", action="store_true", dest="list_keys",
        help="print per-key history summaries and exit",
    )
    ap.add_argument(
        "--kind", default=None,
        help="restrict gating/--list to one record kind (learn | "
        "bench | serve | solve | replay)",
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit verdicts as JSON",
    )
    args = ap.parse_args(argv)

    led = ledger_mod.Ledger(args.ledger)

    if args.seed_from is not None:
        # the seeders import the JAX package's BENCH_r*.json and
        # onchip_r*.jsonl rounds: numbers of another package on another
        # device, which must never enter this port's history
        print(
            "perf-gate: --seed-from is not ported: the seed artifacts "
            "are the JAX package's bench rounds (ROADMAP.md)",
            file=sys.stderr,
        )
        return 2

    def _kind_of(key: str) -> str:
        parts = key.split("|")
        return parts[1] if len(parts) > 1 else ""

    if args.list_keys:
        groups = led.by_key()
        if args.kind:
            groups = {
                k: v for k, v in groups.items()
                if _kind_of(k) == args.kind
            }
        rows = []
        for key, recs in sorted(groups.items()):
            band = ledger_mod.robust_band(
                [r["value"] for r in recs],
                mad_k=args.mad, frac=args.frac,
            )
            rows.append(
                {
                    "key": key,
                    "n": len(recs),
                    "unit": recs[-1].get("unit"),
                    "newest": recs[-1]["value"],
                    "median": band["median"],
                    "lo": band["lo"],
                    "degraded": sum(
                        1 for r in recs if r.get("degraded")
                    ),
                }
            )
        if args.as_json:
            print(json.dumps(rows, indent=1))
        else:
            if not rows:
                print("perf-gate: ledger is empty")
            for r in rows:
                deg = (
                    f", {r['degraded']} degraded"
                    if r["degraded"] else ""
                )
                print(
                    f"  {r['key']}\n"
                    f"    n={r['n']}{deg}  newest "
                    f"{r['newest']:.6g} {r['unit'] or ''}  median "
                    f"{r['median']:.6g}  band lo {r['lo']:.6g}"
                )
        return 0

    record = None
    if args.record is not None:
        try:
            with open(args.record, encoding="utf-8") as f:
                record = json.load(f)
        except (OSError, ValueError) as e:
            print(f"perf-gate: cannot read --record: {e}",
                  file=sys.stderr)
            return 2
        if not isinstance(record, dict) or not record.get("chip"):
            print(
                "perf-gate: --record needs a normalized record "
                "(chip, kind, value, unit[, workload, shape_key, "
                "knobs])",
                file=sys.stderr,
            )
            return 2

    try:
        verdicts = ledger_mod.gate(
            led,
            mad_k=args.mad,
            frac=args.frac,
            min_history=args.min_history,
            record=record,
        )
    except ValueError as e:
        # a malformed --record is a usage error (exit 2), never a
        # regression verdict (exit 1) CI would act on
        print(f"perf-gate: {e}", file=sys.stderr)
        return 2
    if args.kind:
        verdicts = [
            v for v in verdicts if _kind_of(v["key"]) == args.kind
        ]
    judged = [v for v in verdicts if not v.get("skipped")]
    bad = [v for v in judged if not v["ok"]]
    skipped = [v for v in verdicts if v.get("skipped")]
    if args.as_json:
        print(
            json.dumps(
                {
                    "ledger": led.path,
                    "verdicts": verdicts,
                    "n_judged": len(judged),
                    "n_regressions": len(bad),
                    "n_skipped": len(skipped),
                },
                indent=1,
            )
        )
    else:
        for v in judged:
            print(_fmt_verdict(v))
        if skipped:
            print(
                f"perf-gate: {len(skipped)} key(s) skipped "
                "(insufficient history — they start gating as "
                "records accrue)"
            )
        if not verdicts:
            print(
                "perf-gate: ledger is empty — arm "
                "CCSC_PERF_LEDGER on your runs"
            )
        print(
            f"perf-gate: {len(judged)} judged, {len(bad)} "
            f"regression(s) ({led.path})"
        )
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
