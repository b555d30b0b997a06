"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit). Every share of a peak in the benchmark is taken against the bf16
tensor-core rate, the card's highest for these models, so no share of
any precision can pass 100%."""

PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS)
