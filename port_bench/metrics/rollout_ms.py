"""Per iteration of the traced window: the span around the runner's rollout call, synchronized on the device."""


def read(ctx):
    its = ctx.get("iterations") or []
    return sum(i["rollout_ms"] for i in its) / len(its) if its else None
