"""% of the blend kernels' device time that their bounds take (work.py): the
forward, backward and segment-sum kernels over the traced steps."""

KERNELS = ("rasterize_fwd_kernel", "rasterize_bwd_kernel", "segment_sum_kernel")


def read(ctx):
    tr, work = ctx.trace, ctx.step_work()
    if tr is None or not work:
        return None
    spent = tr.device_s(*KERNELS)
    bound = sum(sum(w["bounds"].values()) for w in work)
    return 100.0 * bound / spent if spent > 0 else None
