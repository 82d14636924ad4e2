"""Shrinking heuristics — the paper's Table 3 (copy of ``repro.core.heuristics``).

Two independent dials (Sec. 3.3.1):

* when to shrink      — ``random: k``       fixed iteration interval k
                        ``numsamples: f``   interval = f * |X| iterations
* reconstruction      — ``single``  one gamma-reconstruction; optimization
                                    continues WITHOUT shrinking afterwards
                        ``multi``   reconstruct whenever the active set
                                    converges; shrinking continues throughout

Class tags from the paper: * aggressive, <> average, . conservative.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Policy = Literal["none", "single", "multi"]


@dataclasses.dataclass(frozen=True)
class ShrinkHeuristic:
    name: str
    policy: Policy
    kind: Literal["random", "numsamples", "none"] = "none"
    value: float = 0.0
    klass: str = "N/A"  # aggressive / average / conservative

    def interval(self, n_total: int) -> int:
        """Iterations between shrink-rule applications (0 = never)."""
        if self.policy == "none":
            return 0
        if self.kind == "random":
            return max(1, int(self.value))
        return max(1, int(math.ceil(self.value * n_total)))


def fuse_budget(fuse_iters: int, ckpt_count: int, checkpoint_every: int) -> int:
    """Segments the next fused dispatch may run without crossing a
    checkpoint boundary.

    The checkpoint cadence is counted in *segments* (one segment == one
    legacy dispatch), so a k-segment epoch must stop exactly where the
    k=1 oracle would have saved: min(k, segments until the next multiple
    of ``checkpoint_every``). Always >= 1; ``checkpoint_every <= 0`` (or
    no checkpointing) leaves k uncapped.
    """
    k = max(1, int(fuse_iters))
    if checkpoint_every <= 0:
        return k
    return min(k, checkpoint_every - ckpt_count % checkpoint_every)


ORIGINAL = ShrinkHeuristic("Original", "none")

# Rows 2-13 of Table 3.
TABLE3: dict[str, ShrinkHeuristic] = {"original": ORIGINAL}
for _policy in ("single", "multi"):
    _P = _policy.capitalize()
    for _k, _cls in ((2, "aggressive"), (500, "aggressive"), (1000, "average")):
        _h = ShrinkHeuristic(f"{_P}{_k}", _policy, "random", _k, _cls)
        TABLE3[_h.name.lower()] = _h
    for _pc, _cls in ((5, "aggressive"), (10, "average"), (50, "conservative")):
        _h = ShrinkHeuristic(f"{_P}{_pc}pc", _policy, "numsamples", _pc / 100.0, _cls)
        TABLE3[_h.name.lower()] = _h


def get(name_or_h: "str | ShrinkHeuristic") -> ShrinkHeuristic:
    if isinstance(name_or_h, ShrinkHeuristic):
        return name_or_h
    try:
        return TABLE3[name_or_h.lower()]
    except KeyError:
        raise ValueError(
            f"unknown heuristic {name_or_h!r}; known: {sorted(TABLE3)}") from None
