"""Per iteration of the traced window: the span around the runner's train call, synchronized on the device."""


def read(ctx):
    its = ctx.get("iterations") or []
    return sum(i["learner_ms"] for i in its) / len(its) if its else None
