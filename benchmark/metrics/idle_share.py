"""% of the traced segment's wall in which no operation ran on the card."""


def read(ctx):
    tr = ctx.trace
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.wall_s)
