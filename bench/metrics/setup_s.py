"""Seconds from the start of the process to the first timed unit:
imports, weights, the program's set-up, kernel builds, warm-up."""


def read(ctx):
    return ctx.setup_s
