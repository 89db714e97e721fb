"""Straggler detection and crash-restart training.

Port of ``repro/dist/fault_tolerance.py`` (pure Python there; the port
keeps its own copy). ``StepWatchdog`` flags steps that exceed ``slack``×
a running baseline of healthy step times, the signal a launcher uses to
evict a sick host before it stalls the whole job. ``run_with_restart`` is
the loop around it: deterministic data and atomic checkpoints
(``dist/checkpoint.py``) make a restart replay to the state of an
uninterrupted run, bit for bit where the device's arithmetic is
deterministic.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


class StepWatchdog:
    """Classify each step time as "ok" / "slow" / "sick".

    The first ``warmup`` steps only build the baseline (the first steps
    are slow and healthy). Afterwards a step slower than ``slack *
    baseline`` is "slow", a second consecutive one escalates to "sick",
    and a healthy step resets the strike count. Anomalous steps never
    pollute the baseline.
    """

    def __init__(self, slack: float = 2.0, warmup: int = 3):
        self.slack = float(slack)
        self.warmup = int(warmup)
        self._n = 0
        self._baseline: Optional[float] = None
        self._strikes = 0

    @property
    def baseline(self) -> Optional[float]:
        return self._baseline

    def check(self, step_time: float) -> str:
        self._n += 1
        if self._baseline is None:
            self._baseline = step_time
            return "ok"
        if self._n <= self.warmup:
            self._baseline = min(self._baseline, step_time)
            return "ok"
        if step_time > self.slack * self._baseline:
            self._strikes += 1
            return "slow" if self._strikes == 1 else "sick"
        self._strikes = 0
        self._baseline = 0.9 * self._baseline + 0.1 * step_time
        return "ok"


def run_with_restart(step_fn: Callable, init, n_steps: int, *,
                     save_fn: Optional[Callable] = None,
                     restore_fn: Optional[Callable] = None,
                     ckpt_every: int = 1,
                     fault_injector: Optional[Callable] = None,
                     max_restarts: int = 10) -> tuple[Any, int]:
    """Run ``step_fn(state, step) -> (state, ...)`` for ``n_steps`` steps,
    resuming from the latest checkpoint on any step failure.

    * ``save_fn(state, step)`` is called whenever ``step % ckpt_every == 0``
      (``step`` counts COMPLETED steps, so a checkpoint at step s resumes by
      re-running step s).
    * ``restore_fn() -> (state | None, step)`` supplies the recovery point;
      when it returns ``(None, _)`` (no checkpoint yet) the run restarts
      from ``init``.
    * ``fault_injector(step)`` is a test hook invoked before each step.

    A ``step_fn`` that updates its state in place (the port's train step)
    must be given an ``init`` it may consume, and a ``restore_fn`` that
    returns fresh state: a restart from ``init`` after such a step has run
    starts from what it left there.

    Returns ``(final_state, completed_steps)``.
    """
    state, step = init, 0
    if restore_fn is not None:
        restored, s = restore_fn()
        if restored is not None:
            state, step = restored, s

    restarts = 0
    while step < n_steps:
        try:
            if fault_injector is not None:
                fault_injector(step)
            out = step_fn(state, step)
            state = out[0] if isinstance(out, tuple) else out
            step += 1
            if save_fn is not None and step % ckpt_every == 0:
                save_fn(state, step)
        except Exception:
            restarts += 1
            if restarts > max_restarts or restore_fn is None:
                raise
            restored, s = restore_fn()
            if restored is not None:
                state, step = restored, s
            else:
                state, step = init, 0
    return state, step
