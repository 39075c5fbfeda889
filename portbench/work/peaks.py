"""One NVIDIA H100 SXM (the data sheet's dense rates at 700 W): float32
outside the tensor cores, which is the port's precision (it uses no tensor
cores), and HBM3."""

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(ops: float, nbytes: float):
    """(the least time the chip could take, in ms, and "operations" or
    "bytes", whichever sets it)."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
