"""Device ms a batch in the BFS lane's plain PyTorch passes (counting,
visited update, seeding): every device operation of the traced batches
but the port's three CUDA kernels."""

KERNELS = ("fused_hop_kernel", "gather_or_kernel", "membership_kernel")


def read(ctx):
    n = ctx.counters.get("batches")
    if ctx.trace is None or not n:
        return None
    ms = ctx.trace.device_ms(lambda name: not any(k in name
                                                  for k in KERNELS))
    return ms / n if ms > 0 else None
