"""Quality gate over the durable ledger's ``kind=quality`` records
(serve.quality shadow scoring): the port's counterpart of the JAX
package's ``scripts/quality_gate.py``, with its flags, output and exit
codes.

    python -m ccsc_code_iccv2017_torch.serve.quality_gate --candidate DIGEST
        judge one candidate bank digest vs the live quality history
    ... --candidate DIGEST --bank beta
        restrict to one bank id's records
    ... --list    per-key quality history summaries
    ... --json    machine-readable

A candidate's ``kind=quality`` records (appended by
``serve.quality.score_bank`` — shadow-replaying a captured segment
through the candidate offline) are judged against every OTHER
digest's records under the same ledger key — the quality the
currently-published banks actually served. The band is perf_gate's
robust-band math with the relative frac floor replaced by an
ABSOLUTE dB floor (``--db`` / ``CCSC_QUALITY_GATE_DB``): 25% of a
30 dB median is 7.5 dB, far past any regression worth catching.

Exit status: 0 = no regression (keys with live history thinner than
--min-history / CCSC_PERF_GATE_MIN_HISTORY pass trivially and are
reported as skipped — a young observatory starts gating as scores
accrue), 1 = the candidate fell below the live band on at least one
key, 2 = usage error (no such candidate in the ledger, unreadable
ledger).

This is the CI-runnable end of the quality observatory and the same
judgment ``ServeFleet.publish_bank(..., quality_check=True)`` (or
``CCSC_QUALITY_GATE=1``) applies inline before a hot-swap.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..analysis import ledger as ledger_mod
from . import quality as quality_mod


def _fmt_verdict(v) -> str:
    if v.get("skipped"):
        return (
            f"quality-gate: SKIP  {v['key']}  "
            f"({v.get('reason', 'insufficient history')}, "
            f"n={v.get('n_history', 0)})"
        )
    tag = "OK  " if v["ok"] else "REGRESSION"
    return (
        f"quality-gate: {tag}  {v['key']}  "
        f"{v['value']:.2f} dB ({v.get('delta_db', 0.0):+.2f} dB vs "
        f"live median {v['median']:.2f} dB, band lo "
        f"{v['lo']:.2f} dB, n={v['n_history']})"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--ledger", default=None,
        help="ledger JSONL path (default: CCSC_PERF_LEDGER, else "
        "the standard resolution — the ONE ledger perf_gate reads)",
    )
    ap.add_argument(
        "--candidate", default=None, metavar="DIGEST",
        help="candidate bank content digest (serve.registry."
        "bank_digest) to judge against the live quality history",
    )
    ap.add_argument(
        "--bank", default=None, metavar="BANK_ID",
        help="restrict judgment to records scored for one bank id "
        "(score_bank's knobs.bank; 'default' = the pinned bank)",
    )
    ap.add_argument(
        "--mad", type=float, default=None,
        help="band half-width in MAD-sigmas (CCSC_PERF_GATE_MAD, "
        "default 3.0)",
    )
    ap.add_argument(
        "--db", type=float, default=None,
        help="absolute dB floor of the band — a candidate more than "
        "this far below the live median regresses regardless of "
        "spread (CCSC_QUALITY_GATE_DB, default 1.0)",
    )
    ap.add_argument(
        "--min-history", type=int, default=None,
        help="live records a key needs before the candidate is "
        "judged (CCSC_PERF_GATE_MIN_HISTORY, default 3)",
    )
    ap.add_argument(
        "--list", action="store_true", dest="list_keys",
        help="print per-key quality history summaries and exit",
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit verdicts as JSON",
    )
    args = ap.parse_args(argv)

    led = ledger_mod.Ledger(args.ledger)

    if args.list_keys:
        rows = []
        for key, recs in sorted(led.by_key().items()):
            recs = [
                r for r in recs if r.get("kind") == "quality"
            ]
            if not recs:
                continue
            band = quality_mod.quality_band(
                [r["value"] for r in recs],
                mad_k=args.mad, db=args.db,
            )
            digests = {}
            for r in recs:
                dg = r.get("digest") or "?"
                digests[dg] = digests.get(dg, 0) + 1
            rows.append(
                {
                    "key": key,
                    "n": len(recs),
                    "newest_db": recs[-1]["value"],
                    "median_db": band["median"] if band else None,
                    "lo_db": band["lo"] if band else None,
                    "digests": digests,
                }
            )
        if args.as_json:
            print(json.dumps(rows, indent=1))
        else:
            if not rows:
                print(
                    "quality-gate: no kind=quality records — score "
                    "a bank first (serve.quality.score_bank)"
                )
            for r in rows:
                dgs = ", ".join(
                    f"{dg[:12]}x{n}"
                    for dg, n in sorted(r["digests"].items())
                )
                print(
                    f"  {r['key']}\n"
                    f"    n={r['n']}  newest "
                    f"{r['newest_db']:.2f} dB  median "
                    f"{(r['median_db'] or 0.0):.2f} dB  band lo "
                    f"{(r['lo_db'] or 0.0):.2f} dB  [{dgs}]"
                )
        return 0

    if not args.candidate:
        print(
            "quality-gate: --candidate DIGEST is required "
            "(or --list)",
            file=sys.stderr,
        )
        return 2

    verdicts = quality_mod.judge_candidate(
        led,
        args.candidate,
        bank_id=args.bank,
        mad_k=args.mad,
        db=args.db,
        min_history=args.min_history,
    )
    if not verdicts:
        print(
            f"quality-gate: candidate {args.candidate} has no "
            f"kind=quality record in {led.path} — score it first "
            "(serve.quality.score_bank)",
            file=sys.stderr,
        )
        return 2
    judged = [v for v in verdicts if not v.get("skipped")]
    bad = [v for v in judged if not v["ok"]]
    skipped = [v for v in verdicts if v.get("skipped")]
    if args.as_json:
        print(
            json.dumps(
                {
                    "ledger": led.path,
                    "candidate": args.candidate,
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
                f"quality-gate: {len(skipped)} key(s) skipped "
                "(live history too thin — they start gating as "
                "scores accrue)"
            )
        print(
            f"quality-gate: {len(judged)} judged, {len(bad)} "
            f"regression(s) ({led.path})"
        )
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
