"""The chip's peaks: NVIDIA H100 SXM data sheet, dense rates, at the full
700 W power limit.

Each product is counted at the card's fastest route that keeps its
precision: bf16 x bf16 on the tensor cores; fp32 x fp32 by 3xTF32 (three
TF32 passes at 495 TFLOP/s), not the 67 TFLOP/s of FMA outside the tensor
cores, so that no fp32 route can pass its peak; fp32 x bf16 as a
three-piece bf16 split of the fp32 operand; int8 on the tensor cores.
"""

PEAK_FLOPS = {"bf16": 989e12, "fp32": 495e12 / 3, "fp32xbf16": 989e12 / 3, "int8": 1979e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}


def least_seconds(ops_by_precision: dict, nbytes: float) -> float:
    """The least time for the work: the larger of its operations at each
    precision's peak (summed over precisions) and its bytes at the memory
    rate."""
    t_ops = sum(ops / PEAK_FLOPS[p] for p, ops in ops_by_precision.items())
    return max(t_ops, nbytes / PEAK_BYTES)
