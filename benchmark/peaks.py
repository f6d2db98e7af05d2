"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W), and the least
time a call could take at them."""

from __future__ import annotations

#: FLOP/s by operand type as the profiler names it
PEAK_FLOPS = {
    "c10::BFloat16": 989e12,
    "c10::Half": 989e12,
    "float": 67e12,          # outside the tensor cores (no TF32)
}
#: HBM3 bytes/s
PEAK_BYTES = 3.35e12
#: bytes an element by operand type
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def least_seconds(flop: float, nbytes: float, operand: str) -> float:
    """The larger of ``flop`` at the operand type's peak and ``nbytes`` at
    the memory's."""
    return max(flop / PEAK_FLOPS[operand], nbytes / PEAK_BYTES)
