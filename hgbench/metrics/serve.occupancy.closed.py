"""``ServeStats`` batch occupancy over the traced window: real requests
over padded lanes of every dispatched batch, in %."""


def read(ctx):
    return ctx.counters.get("occupancy")
