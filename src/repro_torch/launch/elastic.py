"""Elastic rescale and straggler mitigation (twin of
``repro.launch.elastic``).

An elastic rescale goes through a checkpoint: a step holds host (n,)
masters only, so :func:`rescale` restores it for whatever process layout
the restarted job has. In the port's one-process-a-device model a rescale
is a restart at another world size; each rank then takes its shard from
the rebuilt buffer geometry (``core.driver``).

:class:`StragglerWatchdog` tracks a robust step-time estimate and flags a
step that takes more than ``threshold`` times the running median; the SVM
epoch driver (``SVMConfig(watchdog_threshold=...)``) then forces a
checkpoint at that dispatch boundary and halves its segment budget.

Recovery path (save boundary == dispatch boundary == restore boundary):

    start_step -> dispatch -> end_step -+- ok --------> next dispatch
                                        +- straggle --> force an atomic
                                              checkpoint at THIS boundary
                                              (+ halve the budget)
    crash / preemption / rescale -> rescale(): the newest COMPLETE step,
    restored for the CURRENT world size.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

from repro_torch.ckpt import checkpoint as ckpt


def rescale(ckpt_base: str, like_trees: dict, device=None,
            step: Optional[int] = None) -> tuple:
    """Restore the newest (or the given) step of ``ckpt_base``.

    ``like_trees``: ``{group: tree}`` of arrays or tensors giving each
    group's structure, shapes and dtypes; ``device``: where the restored
    leaves go (None: numpy arrays). Returns ``(groups, step)``. With no
    ``step``, torn or corrupt step dirs are skipped and the newest step
    whose checksums verify wins."""
    if step is None:
        steps = ckpt.complete_steps(ckpt_base)
        step = steps[-1] if steps else None
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_base}")
    d = os.path.join(ckpt_base, f"step_{step}")
    out = {name: ckpt.restore(d, name, like_trees[name], device)
           for name in like_trees}
    return out, step


class StragglerWatchdog:
    """Step-time anomaly detector with a bounded-memory running median."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 on_straggle: Optional[Callable[[int, float, float], None]]
                 = None, warmup: int = 3):
        self.threshold = threshold
        self.window = window
        self.on_straggle = on_straggle
        self.warmup = warmup
        self._times: list = []
        self._last = None
        self._step = 0
        self.events: list = []

    def start_step(self):
        self._last = time.perf_counter()

    def end_step(self) -> bool:
        """True if this step straggled (a flagged step stays out of the
        median window, so it cannot raise the baseline)."""
        assert self._last is not None, "start_step() not called"
        dt = time.perf_counter() - self._last
        self._step += 1
        if len(self._times) >= self.warmup:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.threshold * med:
                self.events.append((self._step, dt, med))
                if self.on_straggle:
                    self.on_straggle(self._step, dt, med)
                return True
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return False
