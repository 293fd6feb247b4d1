"""Device-busy ms a step of the traced segment (the step's CUDA graph replays)."""


def read(ctx):
    tr = ctx.trace
    return None if tr is None else 1e3 * tr.busy_s / tr.steps
