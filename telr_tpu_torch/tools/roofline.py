"""The least time an H100 could take for a kernel's work.

`bounds(bytes, operations)` is the larger of the bytes the function must
move (each input read once, each output written once) over the card's memory
rate and its integer operations over the card's int32 rate.  chip_smoke.py
and telr_tpu_torch/tools/bench.py give their kernels' bounds with it.
"""

# Memory rate: the H100 SXM's 3.35 TB/s.  Integer rate: NVIDIA's data sheet
# gives 67 TFLOP/s of float32 outside the tensor cores, two operations per
# lane and clock on 128 lanes an SM; the Hopper SM has 64 int32 lanes beside
# them, one operation each, so 67 / 4 = 16.75 T int32 operations a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# Integer operations per band cell, one per add / compare / max / select of
# the recurrences (hopper_dp._rowband_dp_plain, wavefront.py): scores only,
# and with the direction byte and its bits; and per step of the walk.
ROWBAND_OPS = {False: 36, True: 54}
WAVEFRONT_OPS = {False: 34, True: 50}
WALK_OPS_PER_STEP = 20


def bounds(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over the memory rate and its operations over the int32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))
