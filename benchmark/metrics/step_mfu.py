"""% of the traced steps' wall that their counted work takes at the H100's
peaks (work.py: LPIPS in bf16, SSIM/S3IM, the LBS field and the blend in f32)."""


def read(ctx):
    tr, work = ctx.trace, ctx.step_work()
    if tr is None or not work:
        return None
    at_peak = sum(sum(w["at_peak"].values()) for w in work)
    return 100.0 * at_peak / tr.wall_s
