"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline and mfu share."""

BYTES_PER_S = 3.35e12      # HBM3
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # bf16 tensor cores


def bound_s(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """The least seconds an H100 takes to move `nbytes` through its memory
    and do `nops` operations at `ops_per_s`: the larger of the two."""
    return max(nbytes / BYTES_PER_S, nops / ops_per_s)
