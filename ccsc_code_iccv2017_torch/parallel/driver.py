"""The run driver of the port's learners: what the consensus learner
(parallel.consensus, every mesh), the masked learner
(models.learn_masked) and the streamed learner (parallel.streaming) do
between passes, written once (the JAX drivers' protocol,
parallel/consensus.py:560-740, models/learn_masked.py:750-900).

A learner keeps its math, its state and its placement, and hands the
driver its pass. The driver keeps resume (:func:`resume`,
:func:`start_trace`: the checkpoint of the config fingerprint, the
reference's trace protocol obj_vals_d / obj_vals_z / tim_vals / d_diff /
z_diff, dParallel.m:62-71, and the RecoveryManager), the pass loop of
the consensus and masked learners (:meth:`Driver.passes`) and the pass
boundary of all three: the non-finite guard's rho backoff
(:meth:`Driver.diverged`), an adopted step's records and the rel-change
stop (:meth:`Driver.record`, dParallel.m:186-188), preemption and the
checkpoint cadence (:meth:`Driver.end_pass`, :meth:`Driver.finish`).

With ``cfg.watchdog`` a utils.watchdog.DispatchWatchdog is armed around
each pass's one host read (its deadline the perfmodel roofline bound of
the step times ``cfg.watchdog_slack``; on a mesh every rank arms its
own), and the chaos faults of utils.faults fire at the JAX drivers'
points (the NaN poison inside the pass, the hang inside the armed fence,
SIGTERM at the boundary). Every record is written after the pass's read
from the values it brought back: the driver adds no launch and no host
read.
"""
from __future__ import annotations

import contextlib
import time

from ..utils import checkpoint as ckpt
from ..utils import faults, profiling, resilience
from ..utils.resilience import console
from . import mesh as mesh_lib

_OFF = contextlib.nullcontext()


def resume(cfg, checkpoint_dir, fingerprint: str, expect: dict):
    """The checkpoint to resume from: (fields, trace, start_it), its
    shapes checked against the problem's ``expect``; (None, None, 0)
    when there is none."""
    snap = (None if checkpoint_dir is None
            else ckpt.load(checkpoint_dir, expect_fingerprint=fingerprint))
    if snap is None:
        return None, None, 0
    fields, trace, start_it = snap
    check_shapes("checkpoint", fields, expect)
    console(cfg, f"resumed from {checkpoint_dir} at iteration {start_it}",
            always=True)
    return fields, trace, start_it


def check_shapes(what: str, fields: dict, expect: dict, hint: str = ""):
    """Refuse ``fields`` (name: tensor) whose shapes are not ``expect``."""
    got = {k: tuple(v.shape) for k, v in fields.items()}
    if got != expect:
        raise ValueError(
            f"{what} shapes {got} do not match problem {expect}{hint}")


def start_trace(cfg, trace, algorithm: str, obj0=None):
    """The run's trace and its RecoveryManager: the resumed ``trace``, or
    a new one whose objectives start at ``obj0()`` and whose changes at
    0.0 (both empty without ``obj0``: the masked learner records no
    initial objective)."""
    if trace is None:
        o = [] if obj0 is None else [obj0()]
        c = [] if obj0 is None else [0.0]
        trace = {"algorithm": algorithm, "obj_vals_d": o,
                 "obj_vals_z": list(o), "tim_vals": [0.0], "d_diff": c,
                 "z_diff": list(c)}
    trace.setdefault("algorithm", algorithm)
    return trace, resilience.RecoveryManager(cfg, trace)


class Driver:
    """One learner run's pass boundaries: ``run`` its utils.obs run,
    ``save(it)`` its checkpoint of iteration ``it`` (every rank of a mesh
    calls it), ``timers`` (utils.profiling.SectionTimers) charged with
    the passes and the checkpoints, ``step_cost`` the perfmodel cost the
    chunk records score."""

    def __init__(self, cfg, run, trace, recov, save, checkpoint_dir,
                 checkpoint_every, timers=None, step_cost=None):
        self.cfg, self.run, self.trace, self.recov = cfg, run, trace, recov
        self.save, self.checkpoint_dir, self.every = (save, checkpoint_dir,
                                                      checkpoint_every)
        self.timers, self.step_cost = timers, step_cost
        self.saved_it = None  # last iteration committed to the checkpoint dir
        # entered around the pass loop: SIGTERM/SIGINT ask for a
        # checkpoint and a clean exit at the next boundary
        self.gs = resilience.GracefulShutdown()

    def _section(self, name):
        return _OFF if self.timers is None else self.timers.section(name)

    def diverged(self, it: int, vals, note="; keeping last good state"):
        """Step ``it`` (1-based) read non-finite ``vals`` (obj_d, obj_z,
        d_diff, z_diff): True when rho backs off (a ``recovery`` event)
        and the learner retries from its last good state, False when
        recovery is off or spent and the run stops."""
        obj_d, obj_z, d_diff, z_diff = vals
        console(self.cfg, f"Iter {it}: non-finite metrics (obj_d={obj_d}, "
                          f"obj_z={obj_z}, d_diff={d_diff}, z_diff={z_diff})"
                          f"{note}", always=True)
        ev = self.recov.on_divergence(it)
        if ev is None:
            return False
        self.trace.setdefault("recoveries", []).append(ev)
        self.run.event("recovery", **ev)
        return True

    def record(self, it: int, vals, dt: float, line: str, series=(),
               **fields) -> bool:
        """Adopt step ``it`` (1-based; ``dt`` seconds, metrics ``vals``:
        obj_d, obj_z, d_diff, z_diff) into the trace, with ``series``
        ((key, value) pairs), its ``step`` record with ``fields``, and its
        console ``line`` (str.format of it, the metrics, t_total). True
        when the step met ``cfg.tol``."""
        obj_d, obj_z, d_diff, z_diff = vals
        t_total = self.trace["tim_vals"][-1] + dt
        for k, v in (("obj_vals_d", obj_d), ("obj_vals_z", obj_z),
                     ("tim_vals", t_total), ("d_diff", d_diff),
                     ("z_diff", z_diff), *series):
            self.trace.setdefault(k, []).append(v)
        self.run.step(it=it, obj_d=obj_d, obj_z=obj_z, d_diff=d_diff,
                      z_diff=z_diff, t_total=round(t_total, 4), **fields)
        console(self.cfg, line.format(it=it, obj_d=obj_d, obj_z=obj_z,
                                      d_diff=d_diff, z_diff=z_diff,
                                      t_total=t_total))
        return d_diff < self.cfg.tol and z_diff < self.cfg.tol

    def end_pass(self, start: int, length: int, n_adopted: int, dt: float,
                 stop: bool, stop_req=False, mesh=None, after=None) -> bool:
        """The boundary after a pass of ``length`` steps from ``start``
        that adopted ``n_adopted`` in ``dt`` seconds (``stop``: the walk
        stopped the run; ``stop_req``: the pass's agreed shutdown request;
        ``after(it)``: the learner's work after a pass that adopted a
        step). True when the run stops for a preemption."""
        it_end = start + n_adopted
        if n_adopted:
            self.run.chunk(start, length, n_adopted, dt, cost=self.step_cost)
            self.run.heartbeat(it_end, dt)
            if after is not None:
                after(it_end)
            faults.sigterm_tick(it_end)
        # one device: a request raised after the pass's read (the SIGTERM
        # fault) counts now, as in JAX; on a mesh the next pass's agreed
        # read carries it, so every rank decides alike
        preempting = ((stop_req or (mesh is None and self.gs.requested))
                      and not stop and it_end < self.cfg.max_it)
        if preempting:
            self.trace.setdefault("preemptions", []).append(it_end)
            self.run.event("preemption", iteration=it_end,
                           signum=self.gs.signum)
        crossed = n_adopted and it_end // self.every > start // self.every
        if self.checkpoint_dir is not None and (
            (crossed and self.saved_it != it_end) or preempting
        ):
            with self._section("checkpoint"):
                self.save(it_end)
            self.saved_it = it_end
            self.run.drain_timers(self.timers)
        if preempting:
            console(self.cfg, f"preempted: checkpointed iteration {it_end}, "
                              "exiting cleanly", always=True)
        return preempting

    def finish(self, it_done: int) -> None:
        """The final checkpoint, unless the cadence wrote this iteration."""
        if self.checkpoint_dir is not None and self.saved_it != it_done:
            with self._section("checkpoint"):
                self.save(it_done)

    def passes(self, launch, adopt, series, start_it: int, *, tag: str,
               line: str, mesh=None, wd=None, spans=False,
               collectives=False, after=None, context=_OFF) -> int:
        """The pass loop of the consensus and masked learners from
        ``start_it``; writes the final checkpoint and returns the last
        iteration done. ``launch(i, clen, poison_at)`` runs one step or,
        with ``cfg.chunked_driver``, a chunk of ``clen`` steps from ``i``
        (the NaN fault poisons its step ``poison_at``, None: none) and
        returns its rows packed (obj_d, obj_z, d_diff, z_diff, telemetry
        extras, a chunk's flags; ``clen`` each). After the one read
        ``adopt(rows)`` keeps the state the learner's rule adopts and
        returns (rows, active, adopted, rolled) per step (rolled: the
        objective regressed, the state reverted, the run stops);
        ``series(extras)``: an adopted step's trace series and record
        fields. ``tag``: the watchdog window; ``spans``: the profiler
        spans ``ccsc.learn.step`` / ``ccsc.learn.read``; ``collectives``:
        on a mesh each step's ``allreduce_ms`` / ``wire_bytes``;
        ``context``: entered inside the shutdown catcher (a capture)."""
        chunked = self.cfg.chunked_driver
        it_done = start_it
        with self.gs as gs, context:
            i = start_it
            stop = False
            fresh_step = True  # the first fence builds the kernels
            while i < self.cfg.max_it and not stop:
                clen = (min(self.cfg.outer_chunk, self.cfg.max_it - i)
                        if chunked else 1)
                na = faults.nan_iteration()
                poisoned = na is not None and i + 1 <= na <= i + clen
                per_step = collectives and mesh is not None and not chunked
                if per_step:
                    # the step's collectives: bytes counted, device time
                    # recorded (CUDA events, read after the step's read)
                    wire0 = sum(mesh.wire_bytes.values())
                    mesh.record_step()
                t0 = time.perf_counter()
                if wd is not None:
                    wd.arm(clen, f"{tag}_{i}_{i + clen}" if chunked
                           else f"{tag}_{i}",
                           may_compile=fresh_step or poisoned)
                with (profiling.annotate("ccsc.learn.step", str(i))
                      if spans else _OFF):
                    # chaos injection (utils.faults): the pass NaNs its
                    # iterate on the card
                    packed = launch(i, clen,
                                    na - (i + 1) if poisoned else None)
                    if poisoned:
                        faults.consume_nan()
                    # the one host read of the pass (also its device
                    # fence), the telemetry scalars in it
                    with (profiling.annotate("ccsc.learn.read")
                          if spans else _OFF):
                        flat, stop_req = mesh_lib.agree(packed, gs.requested,
                                                        mesh)
                coll = ()
                if per_step:
                    ms = mesh.step_ms()
                    coll = ((() if ms is None else (("allreduce_ms", ms),))
                            + (("wire_bytes",
                                sum(mesh.wire_bytes.values()) - wire0),))
                # injected hang fires INSIDE the armed fence (utils.faults)
                faults.hang_tick(i + clen)
                if wd is not None:
                    wd.disarm()
                fresh_step = False
                rows, active, adopted, rolled = adopt(
                    [flat[r * clen:(r + 1) * clen]
                     for r in range(len(flat) // clen)])
                dt = time.perf_counter() - t0
                if self.timers is not None:
                    self.timers.add("step", dt)
                n_adopted = 0
                for j in range(clen):
                    if not active[j]:
                        break  # the tail after the chunk stopped
                    vals = [c[j] for c in rows]
                    if rolled[j]:
                        console(self.cfg, f"Iter {i + j + 1}: objective "
                                          "regressed, rolling back")
                        self.trace["rolled_back_at"] = i + j + 1
                        stop = True
                        break
                    if not adopted[j]:
                        # the pass kept the last good iterate: only rho
                        # backs off, and the next pass retries from there
                        if self.diverged(i + j + 1, vals[:4]):
                            fresh_step = True  # as JAX's rho rebuild
                        else:
                            stop = True
                        break
                    n_adopted += 1
                    extra, fields = series(vals[4:])
                    if self.record(i + j + 1, vals[:4], dt / clen, line,
                                   (*extra, *coll), **fields):
                        stop = True
                        break
                if self.end_pass(i, clen, n_adopted, dt, stop, stop_req,
                                 mesh, after):
                    stop = True
                i = it_done = i + n_adopted
        self.finish(it_done)
        return it_done
