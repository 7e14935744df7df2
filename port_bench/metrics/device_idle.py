"""1 minus the union of the device activities' intervals over the profiled window's wall time, in %."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
