"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth. A card set below 700 W reaches less; the run prints its limit."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the bandwidth, and which of the two it is."""
    tf, tb = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")
