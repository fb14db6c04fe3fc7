"""K2's share of its roofline: the data bound of the traced window's first
batch (``roofline/k2.py``: what its inputs need, against 3.35 TB/s and
67 T operations/s) over the device time of that batch's K2 launches."""


def read(ctx):
    bound = ctx.counters.get("k2_bound_ms")
    hops = ctx.counters.get("hops")
    if ctx.trace is None or not bound or not hops:
        return None
    k2 = [e - s for n, s, e in ctx.trace.ops if "fused_hop_kernel" in n]
    if len(k2) < hops:
        return None
    return 100.0 * bound / (sum(k2[:hops]) / 1e3)
