"""The table of peaks and the operations and bytes a kernel's inputs need."""

#: NVIDIA H100 SXM, NVIDIA's data sheet: device-memory rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores, the table's closest entry for the
#: kernels' 32-bit integer ORs, operations/s
ALU_OPS_PER_S = 67e12


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it:
    the larger of bytes over the memory rate and operations over the ALU
    rate."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / ALU_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")
