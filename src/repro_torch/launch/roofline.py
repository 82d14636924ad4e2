"""Roofline terms of a piece of work on the H100 (twin of
``repro.launch.roofline``).

Three terms, in seconds:

  compute    = flops_global / (chips * peak FLOP/s)
  memory     = hbm_bytes_global / (chips * 3.35e12 B/s HBM3)
  collective = link_bytes_per_chip / 450e9 B/s (NVLink, each way)

The peaks are the NVIDIA H100 SXM data sheet's dense rates at the full
700 W power limit: 67e12 FLOP/s in fp32 outside the tensor cores and
989e12 in bf16 on them. ``chip_smoke.py`` takes them from here.

The reference prices a compiled XLA program: ``cost_analysis()`` for the
flops and bytes, and ``parse_collectives`` over the optimised HLO text for
the collective bytes. The port runs eagerly and has no compiled program,
so :func:`analyze` takes the counts from the caller, who derives them from
shapes and from the kernels it launches (``core.serve.ServeEngine.roofline``
does so for a serving bucket); the HLO parser has no counterpart here.
"""
from __future__ import annotations

import dataclasses

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, same source
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense, same source
H100_LINK_BYTES_PER_S = 450e9  # NVLink 4 to the host's other cards, one way


@dataclasses.dataclass
class Roofline:
    flops_global: float
    hbm_bytes_global: float
    link_bytes_per_chip: float
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: dict
    bytes_per_device: float = 0.0

    def row(self) -> dict:
        return {
            "flops_global": self.flops_global,
            "hbm_bytes_global": self.hbm_bytes_global,
            "link_bytes_per_chip": self.link_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "collectives": self.collectives,
            "bytes_per_device": self.bytes_per_device,
        }


def analyze(flops: float, bytes_: float, link_bytes: float, chips: int,
            model_flops: float, *, collectives: "dict | None" = None,
            bytes_per_device: float = 0.0,
            peak_flops: float = H100_FP32_FLOPS) -> Roofline:
    """The roofline of work that does ``flops`` operations at
    ``peak_flops`` a card (by default fp32 on the CUDA cores, the SVM
    kernels' math whatever the storage type; ``H100_BF16_FLOPS`` for the
    LM's bf16 products on the tensor cores) and moves ``bytes_`` bytes of
    device memory over all ``chips`` cards, with ``link_bytes`` of
    collective traffic per card."""
    chips = max(1, int(chips))
    t_c = flops / (chips * peak_flops)
    t_m = bytes_ / (chips * H100_BYTES_PER_S)
    t_l = link_bytes / H100_LINK_BYTES_PER_S
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_l)),
              key=lambda kv: kv[1])[0]
    return Roofline(
        flops_global=float(flops), hbm_bytes_global=float(bytes_),
        link_bytes_per_chip=float(link_bytes), chips=chips,
        t_compute=t_c, t_memory=t_m, t_collective=t_l, dominant=dom,
        model_flops=float(model_flops),
        useful_ratio=model_flops / flops if flops else 0.0,
        collectives=dict(collectives or {"counts": {}, "bytes": {}}),
        bytes_per_device=float(bytes_per_device))
