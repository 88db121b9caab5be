"""Three-term roofline model for the dry run's artifacts, with one NVIDIA
H100's rates.

    compute    = FLOPs / (chips x peak FLOP/s)
    memory     = bytes / (chips x HBM bytes/s)
    collective = collective bytes / (chips x link bytes/s)

The dry run counts a rank's own work (``per_device=True``, the default for
its artifacts), so the chip division is skipped.  MODEL_FLOPS = 6 N D
(dense) or 6 N_active D (MoE) gives the useful-compute ratio that catches
remat and redundant work.

The defaults are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W (``kernels/common.py``): 989e12 bf16 FLOP/s on the tensor cores and
3.35e12 HBM bytes/s, and NVLink 4's 450e9 bytes/s a way.  None was
measured for this model: the HBM and FP32 rates were measured against the
data sheet on one card (``chip_smoke.py``'s ``sim`` phase), NVLink cannot
be on one card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.common import (
    H100_SXM_BF16_FLOPS,
    H100_SXM_HBM_BYTES_PER_S,
)

PEAK_FLOPS = H100_SXM_BF16_FLOPS  # bf16 / chip, tensor cores
HBM_BW = H100_SXM_HBM_BYTES_PER_S  # bytes/s / chip
NVLINK_BW = 450e9  # bytes/s a way, NVLink 4 (18 links), data sheet


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (a rank's model FLOPs against the
        FLOPs its step runs)."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> float:
        """The share of the dominant resource's bound that is useful
        compute, (model_flops / peak) / bound_time: 1.0 means the step
        runs exactly at the hardware bound with zero waste.  The peak is
        the one this roofline was made with, flops / compute_s (0 where no
        FLOP was counted)."""
        if self.bound_time_s <= 0 or self.flops <= 0:
            return 0.0
        model_s = self.model_flops * self.compute_s / self.flops
        return model_s / self.bound_time_s

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    *,
    chips: int = 1,
    per_device: bool = True,
    model_flops: float = 0.0,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    link_bw: float = NVLINK_BW,
) -> RooflineTerms:
    div = 1 if per_device else chips
    return RooflineTerms(
        compute_s=flops / div / peak_flops,
        memory_s=bytes_accessed / div / hbm_bw,
        collective_s=collective_bytes / div / link_bw,
        flops=flops / div,
        bytes_accessed=bytes_accessed / div,
        collective_bytes=collective_bytes / div,
        model_flops=model_flops,
    )
