"""Per iteration of the traced window: the iteration's span minus its rollout and learner spans (the runner's stats,
periodic tasks and, in the async regime, the behaviour snapshot); spans synchronized on the device."""


def read(ctx):
    its = ctx.get("iterations") or []
    return sum(i["iteration_ms"] - i["rollout_ms"] - i["learner_ms"] for i in its) / len(its) if its else None
