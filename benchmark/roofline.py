"""The least time an H100 could take for a wavefront DP launch.

A frozen copy of telr_tpu_torch/tools/roofline.py's arithmetic, so that the
yardstick stays where the program cannot move it.  The memory rate is the
published 3.35 TB/s of the H100 SXM.  The int32 rate is DERIVED, not a data
sheet figure: 67 TFLOP/s of float32 outside the tensor cores is two
operations per lane and clock on 128 lanes an SM, and the Hopper SM has 64
int32 lanes beside them, one operation each: 67 / 4 = 16.75 T int32
operations a second (132 SMs x 64 lanes x 1.98 GHz).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# integer operations per band cell of the wavefront DP, one per add /
# compare / max / select of the recurrence: scores only, and with the
# direction byte and its bits
WAVEFRONT_OPS = {False: 34, True: 50}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the int32 rate, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def wavefront_launch(pairs, width: int, tb: bool = True):
    """(bytes, operations) of one wavefront_dp launch over `pairs`, a list of
    (query length, target length), at band width `width`.  A pair's DP has
    lq + lt anti-diagonal steps of `width` cells each: the useful cells, not
    the launch's padded steps and rows.  Bytes are counted once each way:
    the step codes (one byte a step), the initial band (two rows of `width`
    bytes) and 32 bytes of scalars in; four int32 results and, with the
    traceback, one direction byte a cell out."""
    n_bytes = n_ops = 0
    for lq, lt in pairs:
        steps = lq + lt
        cells = steps * width
        n_ops += WAVEFRONT_OPS[tb] * cells
        n_bytes += steps + 2 * width + 32 + 16 + (cells if tb else 0)
    return n_bytes, n_ops
