"""Run supervisor: launch a learner CLI, watch it, restart from its
checkpoint until the run actually completes (the port of the JAX
package's ``scripts/supervise.py``: the same flags, judgments, trace and
exit codes).

The in-process resilience layer (utils.resilience) survives what a
process can survive: divergence, preemption signals, torn snapshots.
It cannot survive the process itself dying — a crashed runtime, an
OOM kill, a watchdog stall abort (utils.watchdog), a wedged card.
Multi-block consensus ADMM tolerates restart from any block boundary,
and every learner here checkpoints at those boundaries — so the
missing piece is purely supervisory, and ad hoc ``while true; do
python -m ...learn_2d; done`` loops get none of the judgment below.
This module is that piece:

- launches the given command as a child process (everything after
  ``--``), teeing its output to a per-attempt log file;
- tails the run's telemetry (``--metrics-dir``, utils.obs) and the
  checkpoint dir for PROGRESS — a child that is alive but has written
  nothing for ``--stall-timeout`` seconds is declared hung, killed
  (SIGTERM, then SIGKILL) and restarted; the in-process watchdog's
  stall abort (exit code 87) is recognized the same way;
- on any crash, restarts from ``--checkpoint-dir`` with exponential
  backoff (``--backoff`` * 2^k, capped) up to ``--max-restarts``;
- on a CLEAN exit, decides completed-vs-preempted from the event
  stream: an attempt whose records include a ``preemption`` was asked
  to stop early and is resumed; one that ran to its summary without
  preemption is done;
- poison-run detection: two consecutive deaths before the FIRST
  checkpoint ever lands mean restarts cannot help (the run dies
  deterministically in setup/compile) — abort with a diagnosis and
  the tail of the last attempt's log instead of burning the restart
  budget;
- writes a parity-checkable trace of every attempt (reason, exit
  code, timestamps, checkpoint presence) to ``--trace`` (default
  ``<metrics-dir>/supervisor_trace.json``), re-written after every
  attempt so the trace survives the supervisor itself being killed.

``--metrics-dir`` is repeatable: a child that writes several streams
(one per subdir) is judged for progress across all of them, and for
preemption PER DIR (a preemption record in any one dir's newest
attempt marks the child preempted; merging the dirs into one stream
would scope every record to whichever dir's run_meta happens to be
newest).

Multi-child mode (``--child``, repeatable): supervise N children —
e.g. one learner per card — each judged and restarted INDEPENDENTLY
with its own restart/preemption
budget. Per-child dirs pair with children by index (give N
``--metrics-dir``/``--checkpoint-dir`` flags, or one parent dir from
which ``child-NN`` subdirs are derived). The run completes when every
child completes; a poison child (or an exhausted budget) stops the
whole fleet with the matching exit code.

Federated serving (``--federate DIR``): exports ``CCSC_DQUEUE_DIR`` to
every child, as the JAX supervisor does; the federated serving children
that read it are ROADMAP.md Queue 1 item 11, second half.

The supervisor also exports ``CCSC_FAULT_STATE_DIR`` to the child (set
to the metrics dir) so injected chaos faults (utils.faults) stay
fire-once ACROSS restarts.

Usage:
    python -m ccsc_code_iccv2017_torch.supervise --checkpoint-dir CK \\
        --metrics-dir M [--max-restarts 5] [--backoff 5] \\
        [--stall-timeout 0] \\
        -- python -m ccsc_code_iccv2017_torch.apps.learn_2d --data ... \\
           --watchdog --checkpoint-dir CK --metrics-dir M

    python -m ccsc_code_iccv2017_torch.supervise --metrics-dir PARENT \\
        --child 'python -m ccsc_code_iccv2017_torch.apps.learn_2d ...' \\
        --child 'python -m ccsc_code_iccv2017_torch.apps.learn_3d ...'

Exit codes: 0 completed; 2 poison run; 3 restart budget exhausted;
4 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import time

from .utils import obs
from .utils.watchdog import EXIT_STALL

EXIT_OK = 0
EXIT_POISON = 2
EXIT_EXHAUSTED = 3
EXIT_USAGE = 4
# internal: a multi-child sibling failed terminally and this child was
# stopped mid-flight — not this child's own failure, so it never
# becomes the fleet exit code
EXIT_STOPPED = 5

_CKPT_FILES = ("ccsc_state.npz", "ccsc_state.prev.npz")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "--checkpoint-dir", action="append", default=None,
        help="the child's checkpoint dir — the restart point, and the "
        "poison-run detector's evidence of first progress. Repeatable "
        "in multi-child mode (paired with --child by index)",
    )
    p.add_argument(
        "--metrics-dir", action="append", default=None,
        help="the child's utils.obs metrics dir(s): progress signal "
        "for hang detection, preempted-vs-completed on clean exits "
        "(judged PER DIR), "
        "and the fault-marker state dir (CCSC_FAULT_STATE_DIR). "
        "Repeatable",
    )
    p.add_argument(
        "--child", action="append", default=None, metavar="CMDLINE",
        help="multi-child mode: supervise this shell-quoted command "
        "as one independent child (repeatable; mutually exclusive "
        "with the trailing `-- CMD`). Each child gets its own "
        "restart/preemption budget and its own per-index dirs",
    )
    p.add_argument(
        "--federate", default=None, metavar="DIR",
        help="cross-host federation: export CCSC_DQUEUE_DIR=DIR to "
        "every child (the federated serving children that read it "
        "are not ported yet)",
    )
    p.add_argument(
        "--max-restarts", type=int, default=5,
        help="crash-restart budget (crashes, stall aborts, hang "
        "kills). Orderly preemptions — clean exits that checkpointed "
        "and asked to be resumed — have their own budget "
        "(--max-preemptions): a healthy run on preemptible capacity "
        "must not be abandoned for being preempted often",
    )
    p.add_argument("--max-preemptions", type=int, default=100)
    p.add_argument(
        "--backoff", type=float, default=5.0,
        help="base restart delay; attempt k sleeps backoff * 2^(k-1), "
        "capped at --backoff-cap",
    )
    p.add_argument("--backoff-cap", type=float, default=300.0)
    p.add_argument(
        "--stall-timeout", type=float, default=0.0,
        help="kill the child when its metrics/checkpoint dirs show no "
        "progress for this many seconds (0 = rely on the in-process "
        "watchdog's stall abort only)",
    )
    p.add_argument(
        "--trace", default=None,
        help="where to write the supervisor trace JSON (default "
        "<metrics-dir>/supervisor_trace.json)",
    )
    p.add_argument(
        "--log-dir", default=None,
        help="per-attempt child logs (default <metrics-dir>, else cwd)",
    )
    p.add_argument(
        "cmd", nargs=argparse.REMAINDER,
        help="the learner command, after a literal --",
    )
    return p


def _progress_stamp(paths):
    """A monotone token of on-disk progress: newest (mtime, size) over
    every file under the watched dirs — accepts a LIST of dirs and
    additionally scans one level of subdirectories, so a child watched
    only by its top-level dir still shows its subdirs' stream writes
    as progress. Changes whenever the child writes an event, a
    heartbeat, or a checkpoint."""
    stamp = (0.0, 0)
    for root in paths:
        if not root or not os.path.isdir(root):
            continue
        try:
            names = os.listdir(root)
        except OSError:
            continue
        for name in names:
            fp = os.path.join(root, name)
            try:
                st = os.stat(fp)
            except OSError:
                continue
            if os.path.isdir(fp):
                try:
                    sub = os.listdir(fp)
                except OSError:
                    continue
                for s in sub:
                    try:
                        sst = os.stat(os.path.join(fp, s))
                    except OSError:
                        continue
                    stamp = max(stamp, (sst.st_mtime, sst.st_size))
                continue
            stamp = max(stamp, (st.st_mtime, st.st_size))
    return stamp


def _checkpoint_exists(checkpoint_dirs) -> bool:
    return any(
        os.path.exists(os.path.join(d, f))
        for d in checkpoint_dirs if d
        for f in _CKPT_FILES
    )


def _dir_preempted(metrics_dir) -> bool:
    events = obs.read_events(metrics_dir)
    last_meta = max(
        (i for i, e in enumerate(events) if e.get("type") == "run_meta"),
        default=-1,
    )
    return any(
        e.get("type") == "preemption" for e in events[last_meta + 1 :]
    )


def _attempt_preempted(metrics_dirs) -> bool:
    """Whether the NEWEST attempt in any of the child's event streams
    was preempted (asked to checkpoint-and-exit early) — a clean exit
    that still wants a resume. Records after the last run_meta are
    that attempt's.

    Judged PER DIR: a child with several streams is preempted when any
    one of them is. Merging the dirs into a single stream first would
    scope every record to whichever dir's run_meta happens to be
    newest."""
    return any(_dir_preempted(d) for d in metrics_dirs if d)


class _PreemptionTail:
    """Incremental form of :func:`_attempt_preempted` for the
    supervisor loop: the stateless judge re-reads every stream from
    byte 0 after EVERY attempt, which over a long supervised run (N
    attempts x M streams, each growing monotonically) turns the
    judgment quadratic in the stream size. This tail rides
    ``utils.obs.EventTail`` — one offset per file, only appended
    records are parsed — and folds the same per-dir state machine:
    a ``run_meta`` opens a fresh attempt (clearing the flag), a
    ``preemption`` after it marks the dir preempted."""

    def __init__(self, metrics_dirs):
        self._tails = {
            d: obs.EventTail(d) for d in metrics_dirs if d
        }
        self._flag = {d: False for d in self._tails}

    def preempted(self) -> bool:
        for d, tail in self._tails.items():
            for rec in tail.poll():
                kind = rec.get("type")
                if kind == "run_meta":
                    self._flag[d] = False
                elif kind == "preemption":
                    self._flag[d] = True
        return any(self._flag.values())


def _tail(path, nbytes=2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return "(no log)"


class Supervisor:
    """The judgment loop for ONE child. Multi-child mode instantiates
    N of these (one per ``--child``), each with its own budgets, trace,
    and per-index dirs; ``stop_event`` lets a sibling's terminal
    failure stop this child's loop promptly (reason ``fleet_stop``)."""

    def __init__(
        self, args, cmd, metrics_dirs, checkpoint_dirs,
        label="", trace_path=None, stop_event=None,
    ):
        self.args = args
        self.cmd = cmd
        self.metrics_dirs = [m for m in metrics_dirs if m]
        self.checkpoint_dirs = [c for c in checkpoint_dirs if c]
        self.label = label
        self.stop_event = stop_event
        self.attempts = []
        self.restarts = 0  # crash restarts (charged to --max-restarts)
        self.resumes = 0  # preemption resumes (--max-preemptions)
        self.outcome = None
        base = self.metrics_dirs[0] if self.metrics_dirs else "."
        trace_name = (
            f"supervisor_trace-{label}.json"
            if label and not self.metrics_dirs
            else "supervisor_trace.json"
        )
        self.trace_path = trace_path or os.path.join(base, trace_name)
        self.log_dir = args.log_dir or base
        os.makedirs(self.log_dir, exist_ok=True)
        for m in self.metrics_dirs:
            os.makedirs(m, exist_ok=True)
        # incremental preemption judgment across attempts: each
        # judge costs O(records this attempt wrote), not O(stream)
        self._preempt_tail = _PreemptionTail(self.metrics_dirs)

    def _say(self, msg: str) -> None:
        tag = f" [{self.label}]" if self.label else ""
        print(f"supervise{tag}: {msg}", flush=True)

    # -- trace ---------------------------------------------------------
    def _write_trace(self):
        os.makedirs(
            os.path.dirname(os.path.abspath(self.trace_path)),
            exist_ok=True,
        )
        tmp = self.trace_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "cmd": self.cmd,
                    "label": self.label,
                    "checkpoint_dir": self.checkpoint_dirs,
                    "metrics_dir": self.metrics_dirs,
                    "max_restarts": self.args.max_restarts,
                    "restarts": self.restarts,
                    "resumes": self.resumes,
                    "outcome": self.outcome,
                    "attempts": self.attempts,
                },
                f,
                indent=2,
            )
        os.replace(tmp, self.trace_path)

    # -- one attempt ---------------------------------------------------
    def _run_attempt(self, n: int):
        a = self.args
        tag = f"-{self.label}" if self.label else ""
        log_path = os.path.join(
            self.log_dir, f"supervise{tag}-attempt-{n}.log"
        )
        env = dict(os.environ)
        if self.metrics_dirs:
            # fault fire-once markers survive restarts (utils.faults)
            env.setdefault("CCSC_FAULT_STATE_DIR", self.metrics_dirs[0])
        if a.federate:
            # the shared work-queue dir rides the env, as in JAX
            env["CCSC_DQUEUE_DIR"] = a.federate
        watched = self.metrics_dirs + self.checkpoint_dirs
        rec = {
            "attempt": n,
            "start_t": time.time(),
            "log": log_path,
            "checkpoint_at_start": _checkpoint_exists(
                self.checkpoint_dirs
            ),
        }
        with open(log_path, "wb") as logf:
            proc = subprocess.Popen(
                self.cmd, stdout=logf, stderr=subprocess.STDOUT, env=env
            )
            stamp = _progress_stamp(watched)
            quiet_since = time.monotonic()
            killed_for_hang = False
            killed_for_stop = False

            def _kill():
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

            while True:
                try:
                    proc.wait(timeout=1.0)
                    break
                except subprocess.TimeoutExpired:
                    pass
                if self.stop_event is not None and self.stop_event.is_set():
                    # a sibling child failed terminally — stop this one
                    self._say("sibling child failed — stopping")
                    killed_for_stop = True
                    _kill()
                    break
                if a.stall_timeout <= 0:
                    continue
                new_stamp = _progress_stamp(watched)
                now = time.monotonic()
                if new_stamp != stamp:
                    stamp = new_stamp
                    quiet_since = now
                elif now - quiet_since > a.stall_timeout:
                    self._say(
                        f"no progress for {a.stall_timeout:g}s"
                        " — declaring the child hung, killing it"
                    )
                    killed_for_hang = True
                    _kill()
                    break
        rc = proc.returncode
        rec.update(
            end_t=time.time(),
            rc=rc,
            checkpoint_present=_checkpoint_exists(self.checkpoint_dirs),
        )
        if killed_for_stop:
            rec["reason"] = "fleet_stop"
        elif killed_for_hang:
            rec["reason"] = "hang"
        elif rc == EXIT_STALL:
            rec["reason"] = "stall_abort"
        elif rc != 0:
            rec["reason"] = "crash"
        elif self._preempt_tail.preempted():
            rec["reason"] = "preempted"
        else:
            rec["reason"] = "completed"
        return rec

    # -- the loop ------------------------------------------------------
    def run(self) -> int:
        a = self.args
        pre_ckpt_deaths = 0
        attempt = 0
        while True:
            attempt += 1
            rec = self._run_attempt(attempt)
            self.attempts.append(rec)
            self._write_trace()
            reason = rec["reason"]
            self._say(f"attempt {attempt} -> {reason} (rc={rec['rc']})")
            if reason == "completed":
                self.outcome = "completed"
                self._write_trace()
                return EXIT_OK
            if reason == "fleet_stop":
                self.outcome = "stopped"
                self._write_trace()
                return EXIT_STOPPED
            # every other reason wants a relaunch — judge it first
            died = reason in ("crash", "stall_abort", "hang")
            if died and not rec["checkpoint_present"]:
                pre_ckpt_deaths += 1
                if pre_ckpt_deaths >= 2:
                    self.outcome = "poison"
                    self._write_trace()
                    self._say(
                        "POISON RUN — two consecutive deaths "
                        "before the first checkpoint ever landed; a "
                        "restart cannot help (the run dies "
                        "deterministically in setup/compile). Last "
                        "output:\n" + _tail(rec["log"])
                    )
                    return EXIT_POISON
            else:
                pre_ckpt_deaths = 0
            if not died:
                # an orderly preemption checkpointed and asked to be
                # resumed: it consumes its OWN (generous) budget, not
                # the crash-restart budget — a healthy run on
                # preemptible capacity is resumed, not abandoned. No
                # backoff either: nothing is broken.
                if self.resumes >= a.max_preemptions:
                    self.outcome = "exhausted"
                    self._write_trace()
                    self._say(
                        "preemption-resume budget "
                        f"({a.max_preemptions}) exhausted."
                    )
                    return EXIT_EXHAUSTED
                self.resumes += 1
                self._say(
                    f"resuming preempted run (resume "
                    f"{self.resumes}/{a.max_preemptions})"
                )
                continue
            if self.restarts >= a.max_restarts:
                self.outcome = "exhausted"
                self._write_trace()
                self._say(
                    f"restart budget ({a.max_restarts}) "
                    "exhausted. Last output:\n" + _tail(rec["log"])
                )
                return EXIT_EXHAUSTED
            self.restarts += 1
            delay = min(
                a.backoff * (2 ** (self.restarts - 1)), a.backoff_cap
            )
            if delay > 0:
                self._say(
                    f"restart {self.restarts}/{a.max_restarts} "
                    f"in {delay:g}s"
                )
                if self.stop_event is not None:
                    # interruptible backoff: a sibling failure must
                    # not leave this child sleeping out its delay
                    self.stop_event.wait(delay)
                else:
                    time.sleep(delay)


def _pair_dirs(dirs, n: int, flag: str):
    """Pair repeated dir flags with N children: N flags pair by index,
    ONE flag is a parent from which child-NN subdirs are derived, none
    means no dirs. Anything else is a usage error."""
    if not dirs:
        return [[] for _ in range(n)]
    if len(dirs) == n:
        return [[d] for d in dirs]
    if len(dirs) == 1:
        return [
            [os.path.join(dirs[0], f"child-{i:02d}")] for i in range(n)
        ]
    raise ValueError(
        f"{flag}: got {len(dirs)} dirs for {n} children — give one "
        "per child (paired by index), a single parent dir (child-NN "
        "subdirs are derived), or none"
    )


def _run_fleet(args, mdirs, ckdirs) -> int:
    """Multi-child mode: one Supervisor per ``--child``, each driven on
    its own thread with independent budgets. The run completes when
    every child completes; the FIRST terminal failure (poison,
    exhausted budget) stops the siblings and becomes the exit code."""
    import threading

    cmds = [shlex.split(c) for c in args.child]
    n = len(cmds)
    try:
        m_per = _pair_dirs(mdirs, n, "--metrics-dir")
        ck_per = _pair_dirs(ckdirs, n, "--checkpoint-dir")
    except ValueError as e:
        print(f"supervise: {e}", file=sys.stderr)
        return EXIT_USAGE
    stop = threading.Event()
    sups = [
        Supervisor(
            args, cmds[i], m_per[i], ck_per[i],
            label=f"child-{i:02d}", stop_event=stop,
        )
        for i in range(n)
    ]
    codes = [None] * n

    def _drive(i):
        try:
            codes[i] = sups[i].run()
        except BaseException:  # a crashed supervisor fails the fleet
            codes[i] = EXIT_EXHAUSTED
            raise
        finally:
            if codes[i] not in (EXIT_OK, EXIT_STOPPED):
                stop.set()

    threads = [
        threading.Thread(
            target=_drive, args=(i,), name=f"supervise-child-{i:02d}"
        )
        for i in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rc = next(
        (c for c in codes if c not in (EXIT_OK, EXIT_STOPPED)), EXIT_OK
    )
    if args.trace:
        # fleet-level summary next to the per-child traces
        tmp = args.trace + ".tmp"
        os.makedirs(
            os.path.dirname(os.path.abspath(args.trace)), exist_ok=True
        )
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "children": [
                        {
                            "label": s.label,
                            "cmd": s.cmd,
                            "outcome": s.outcome,
                            "rc": codes[i],
                            "trace": s.trace_path,
                        }
                        for i, s in enumerate(sups)
                    ],
                    "rc": rc,
                },
                f,
                indent=2,
            )
        os.replace(tmp, args.trace)
    print(
        f"supervise: fleet done — "
        + ", ".join(f"{s.label}={s.outcome}" for s in sups),
        flush=True,
    )
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    mdirs = list(args.metrics_dir or [])
    ckdirs = list(args.checkpoint_dir or [])
    if args.child:
        if cmd:
            print(
                "supervise: --child and a trailing `-- CMD` are "
                "mutually exclusive",
                file=sys.stderr,
            )
            return EXIT_USAGE
        return _run_fleet(args, mdirs, ckdirs)
    if not cmd:
        print(
            "supervise: no command given — pass the learner CLI after "
            "`--` (or use --child)",
            file=sys.stderr,
        )
        return EXIT_USAGE
    sup = Supervisor(args, cmd, mdirs, ckdirs, trace_path=args.trace)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
