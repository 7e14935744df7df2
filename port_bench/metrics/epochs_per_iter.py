"""The learner's epochs a train call (`epochs_executed` of the stats it returns: it stops early on a flat epoch
loss), averaged over the traced window's iterations."""


def read(ctx):
    its = ctx.get("iterations") or []
    return sum(i["epochs"] for i in its) / len(its) if its else None
