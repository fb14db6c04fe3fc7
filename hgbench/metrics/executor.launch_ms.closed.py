"""Host ms a batch in ``DeviceExecutor.launch`` (pin the view, route the
lanes, dispatch, stage the copies) over the traced window, from the
executor's own ``timing['bfs']``."""


def read(ctx):
    return ctx.counters.get("launch_ms")
