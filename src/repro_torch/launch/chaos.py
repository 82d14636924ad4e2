"""Fault injection for the SVM epoch cycle — the chaos harness (twin of
``repro.launch.chaos``).

The epoch drivers (``core.driver``, ``core.multi``) call two process-local
hooks at their fault boundaries:

  * ``on_dispatch(i)``   just before fused-epoch dispatch #i (0-based);
  * ``on_save(k)``       just before checkpoint save #k (0-based).

Both are one attribute read unless a :class:`FaultPlan` is installed. An
installed plan can KILL the fit at a chosen dispatch or save boundary
(:class:`InjectedKill`, the process-crash stand-in) or DELAY chosen
dispatches by a fixed sleep (a straggler as the host sees it: the
dispatch's wall time grows, the signal ``launch.elastic.StragglerWatchdog``
watches). On a process group every rank reaches every boundary with the
same counters, so a plan installed on every rank kills them all at the
same boundary, before any collective of that dispatch.

On-disk corruption is injected separately, after the fit died:
:func:`corrupt_step` truncates or bit-flips a step's group file or tears
its manifest, and the checkpoint layer's ``complete_steps`` walk must
skip it.

Specs (:func:`parse_spec`): ``kill@3``, ``kill-save@2``,
``delay@5:0.25``, ``delay-all@1:0.1``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional


class InjectedKill(RuntimeError):
    """The injected process death, raised from a fault boundary."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject, keyed by 0-based boundary counters."""
    kill_at_dispatch: Optional[int] = None   # raise before dispatch #i
    kill_at_save: Optional[int] = None       # raise before save #k
    delay_dispatch: Optional[int] = None     # sleep before dispatch #i ...
    delay_seconds: float = 0.0               # ... for this long
    delay_every: bool = False                # delay EVERY dispatch >= index

    dispatches: int = 0                      # boundaries seen
    saves: int = 0


_PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or, with None, clear) the process-local fault plan."""
    global _PLAN
    _PLAN = plan


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Scoped install: ``with chaos.inject(FaultPlan(kill_at_dispatch=3)):``"""
    install(plan)
    try:
        yield plan
    finally:
        install(None)


def on_dispatch(i: int) -> None:
    """Driver hook: called before fused-epoch dispatch #i launches."""
    p = _PLAN
    if p is None:
        return
    p.dispatches = i + 1
    if p.delay_dispatch is not None and (
            i == p.delay_dispatch
            or (p.delay_every and i >= p.delay_dispatch)):
        time.sleep(p.delay_seconds)
    if p.kill_at_dispatch is not None and i >= p.kill_at_dispatch:
        raise InjectedKill(f"injected kill at dispatch {i}")


def on_save(k: int) -> None:
    """Driver hook: called before checkpoint save #k is written."""
    p = _PLAN
    if p is None:
        return
    p.saves = k + 1
    if p.kill_at_save is not None and k >= p.kill_at_save:
        raise InjectedKill(f"injected kill at save {k}")


# -- on-disk corruption (faults after the fit died) --------------------------
def truncate_file(path: str, keep: int = 64) -> None:
    """Truncate ``path`` to its first ``keep`` bytes (a torn write)."""
    with open(path, "r+b") as f:
        f.truncate(keep)


def flip_byte(path: str, offset: int = -1) -> None:
    """XOR one byte of ``path`` (silent media corruption); ``offset`` may
    count from the end, the default flips the last byte."""
    size = os.path.getsize(path)
    pos = offset % size
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def corrupt_step(ckpt_dir: str, step: Optional[int] = None,
                 mode: str = "truncate") -> str:
    """Corrupt ONE step directory under ``ckpt_dir`` (default: the
    newest): 'truncate' / 'flip' hit its first group file, 'manifest'
    tears the manifest. Returns the corrupted step dir."""
    from repro_torch.ckpt import checkpoint as ck
    if step is None:
        step = ck.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    if mode == "manifest":
        truncate_file(os.path.join(d, "manifest.json"), keep=8)
        return d
    man = ck.load_manifest(d)
    fn = os.path.join(d, next(iter(man["groups"].values()))["file"])
    if mode == "truncate":
        truncate_file(fn)
    elif mode == "flip":
        flip_byte(fn)
    else:
        raise ValueError(f"unknown corruption mode {mode!r} "
                         "(want 'truncate' | 'flip' | 'manifest')")
    return d


def parse_spec(spec: str) -> FaultPlan:
    """A :class:`FaultPlan` from a spec:

      kill@I          kill before dispatch I
      kill-save@K     kill before checkpoint save K
      delay@I:S       sleep S seconds before dispatch I
      delay-all@I:S   sleep S seconds before every dispatch >= I
    """
    kind, _, rest = spec.partition("@")
    if not rest:
        raise ValueError(f"bad chaos spec {spec!r} (want KIND@N[:SECS])")
    if kind == "kill":
        return FaultPlan(kill_at_dispatch=int(rest))
    if kind == "kill-save":
        return FaultPlan(kill_at_save=int(rest))
    if kind in ("delay", "delay-all"):
        idx, _, secs = rest.partition(":")
        return FaultPlan(delay_dispatch=int(idx),
                         delay_seconds=float(secs or 0.1),
                         delay_every=kind == "delay-all")
    raise ValueError(f"unknown chaos kind {kind!r} "
                     "(want kill | kill-save | delay | delay-all)")
