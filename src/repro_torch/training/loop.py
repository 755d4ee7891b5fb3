"""Fault-tolerant training loop (the port of ``repro/training/loop.py``).

  * checkpoint/restart: async checkpoints every ``ckpt_every`` steps; on
    *any* step failure the loop restores the latest checkpoint and replays
    -- the stateless data pipeline guarantees the identical token stream
    (``fault_hook`` lets tests inject the failures);
  * validate-and-update (zero-bubble style, paper §5.1): instead of a
    synchronous per-step NaN/inf check stalling the pipeline, the loss is
    validated one step *behind*; a non-finite step triggers a rollback to
    the pre-step snapshot kept on the host (a step that is non-finite
    again after its rollback raises, where the reference rolls back
    without end, and the loop restarts from its checkpoint);
  * straggler mitigation: per-step wall time is tracked against an EMA
    seeded by the first step; a step slower than ``straggler_factor`` x
    the EMA is counted;
  * elastic scaling: ``resume`` restores the newest checkpoint onto
    another plan and mesh through the checkpointer's elastic placement.

The port's train step updates its state in place, so the rollback
snapshot is an owned host copy of this rank's state (never a view of it),
and a rollback or a restore writes into the live tensors (``copy_``): the
pinned host parts of split leaves stay, and no second copy of the state
is placed on the device.  On a multi-rank plan every rank takes the same
decisions: the loss is all-reduced over ``data`` and broadcast over the
stages, so each rank sees the same non-finite step; checkpoints are
collective (rank 0 writes) and every rank restores the same step.  A
fault that only one rank sees would leave the others in a collective:
restarting a single rank is out of scope.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.training.checkpoint import (Checkpointer, StatePlacement,
                                             host_snapshot, load_into,
                                             nbytes)


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 2.0
    ema_beta: float = 0.9
    validate_delay: bool = True     # zero-bubble delayed NaN check
    max_restarts: int = 3


@dataclass
class LoopStats:
    steps_done: int = 0
    restarts: int = 0
    rollbacks: int = 0
    straggler_events: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    # the rollback snapshots: seconds each, and the bytes of the last
    snapshot_times: List[float] = field(default_factory=list)
    snapshot_bytes: int = 0


class TrainLoop:
    def __init__(self, step_fn: Callable, state: Any, batches: Iterator,
                 *, ckpt_dir: str, cfg: LoopConfig = LoopConfig(),
                 place: Optional[StatePlacement] = None,
                 meta: Optional[Dict] = None,
                 fault_hook: Optional[Callable[[int], None]] = None):
        """step_fn(state, batch) -> (state, metrics dict with 'loss').

        ``place``: where the state lives (``StatePlacement``); None for a
        state on one device, or any tree of tensors and arrays.
        ``fault_hook(step)`` (tests) may raise to simulate a node failure.
        """
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.cfg = cfg
        self.ckpt = Checkpointer(ckpt_dir, keep=cfg.keep_ckpts)
        self.place = place
        self.meta = meta or {}
        self.fault_hook = fault_hook
        self.stats = LoopStats()
        self._step = 0
        self._ema_time: Optional[float] = None
        self._prev_snapshot: Any = None      # host copy for rollback
        self._spare: Any = None              # an older one, written over
        self._snapshot_step = 0
        self._rolled_back_at: Optional[int] = None

    # -- core ------------------------------------------------------------------
    def run(self) -> LoopStats:
        restarts = 0
        while self._step < self.cfg.total_steps:
            try:
                self._run_segment()
            except KeyboardInterrupt:
                raise
            except Exception as e:                     # node failure path
                restarts += 1
                self.stats.restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                self._restore_latest()
        self.ckpt.wait()
        return self.stats

    def _run_segment(self):
        cfg = self.cfg
        while self._step < cfg.total_steps:
            batch = self.batches(self._step) if callable(self.batches) \
                else next(self.batches)
            if self.fault_hook is not None:
                self.fault_hook(self._step)
            t0 = time.perf_counter()
            snapshot = None
            if cfg.validate_delay and self._step % cfg.ckpt_every == 0:
                # keep a host snapshot to roll back a bad step
                snapshot = host_snapshot(self.state, self._spare)
                self._spare = None
                self.stats.snapshot_times.append(time.perf_counter() - t0)
                self.stats.snapshot_bytes = nbytes(snapshot)
            new_state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            # delayed validation (zero-bubble validate-and-update)
            if not math.isfinite(loss):
                if snapshot is not None:
                    self._spare = snapshot
                if self._rolled_back_at == self._step:
                    raise FloatingPointError(
                        f"non-finite loss at {self._step} again after a "
                        "rollback")
                self.stats.rollbacks += 1
                if cfg.validate_delay and self._prev_snapshot is not None:
                    self._rolled_back_at = self._step
                    self.state = load_into(self.state, self._prev_snapshot)
                    self._step = self._snapshot_step
                    continue
                raise FloatingPointError(f"non-finite loss at {self._step}")
            if snapshot is not None:
                self._spare, self._prev_snapshot = self._prev_snapshot, \
                    snapshot
                self._snapshot_step = self._step

            if self._rolled_back_at == self._step:
                self._rolled_back_at = None
            self.state = new_state
            self._track(loss, dt)
            self._step += 1
            if self._step % cfg.ckpt_every == 0:
                self.ckpt.save_async(self._step, self.state,
                                     {"meta": self.meta}, place=self.place)
        return self.stats

    # -- helpers -----------------------------------------------------------------
    def _track(self, loss: float, dt: float):
        st, cfg = self.stats, self.cfg
        st.steps_done += 1
        st.losses.append(loss)
        st.step_times.append(dt)
        if self._ema_time is None:
            self._ema_time = dt
        else:
            if dt > cfg.straggler_factor * self._ema_time:
                st.straggler_events += 1
            self._ema_time = (cfg.ema_beta * self._ema_time
                              + (1 - cfg.ema_beta) * dt)

    def _restore_latest(self):
        self.ckpt.wait()
        if self.place is not None:
            self.place.barrier()        # rank 0's write has landed
        step = self.ckpt.latest_step()
        if step is None:
            self._step = 0
            return
        step, state, _ = self.ckpt.restore(step, place=self.place,
                                           into=self.state)
        self.state = state
        self._step = step

    # -- elastic resume ------------------------------------------------------------
    @staticmethod
    def resume(ckpt_dir: str, place: Optional[StatePlacement] = None,
               into: Any = None):
        """Restore the newest checkpoint onto (possibly another) plan and
        mesh, into the live state ``into`` in place when given.  Returns
        (step, state, manifest)."""
        ck = Checkpointer(ckpt_dir)
        return ck.restore(place=place, into=into)
