"""Host ms a batch in ``DeviceExecutor.collect`` (wait on the batch's copy
event, build the answers) over the traced window, from the executor's own
``timing['bfs']``."""


def read(ctx):
    return ctx.counters.get("collect_ms")
