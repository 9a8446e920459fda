"""The share of the profiled stretch of whole solves in which no kernel or
copy ran on the card (the complement of the union of its device
intervals)."""


def read(ctx):
    p = ctx.profile
    if p is None or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100 * (1 - p["busy_s"] / p["window_s"])
