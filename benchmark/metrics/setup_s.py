"""Seconds from the process's start to the first timed frame or batch:
imports, kernel builds (none once built), inputs, the map of a query
cell and the warm-up."""


def read(ctx):
    return ctx.setup_s
