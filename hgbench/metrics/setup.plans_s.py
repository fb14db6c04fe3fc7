"""Seconds to build the fused plan and put it on the card
(``fused_bfs.device_fused_plan``), by the benchmark's span."""


def read(ctx):
    return ctx.spans.get("setup.plans")
