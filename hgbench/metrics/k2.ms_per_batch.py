"""Device ms a batch in K2, the fused hop (``csrc/fused_hop.cu``)."""


def read(ctx):
    n = ctx.counters.get("batches")
    if ctx.trace is None or not n:
        return None
    ms = ctx.trace.device_ms(lambda name: "fused_hop_kernel" in name)
    return ms / n if ms > 0 else None
