"""Seconds to build the graph and its snapshot from the drawn tables
(``CSRSnapshot.from_tables``; for a served graph ``bulk_import`` and the
snapshot manager's first pack and upload), by the benchmark's span."""


def read(ctx):
    return ctx.spans.get("setup.build")
