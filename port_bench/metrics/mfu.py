"""The whole step's share of the configuration's precision peak, in %: model flops an env step (`flops.py`, from the
configuration's widths, with the epochs each profiled train call ran) times the profiled window's env steps, over
its time and the peak."""

from port_bench.flops import model_flops_per_env_step


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["wall_s"] <= 0:
        return None
    config = ctx["config"]
    rollout = int(config["flags"]["rollout"])
    steps_per_iteration = ctx["steps_per_iteration"]
    flops = sum(model_flops_per_env_step(config["model"], rollout, e) * steps_per_iteration for e in prof["epochs"])
    return 100.0 * flops / prof["wall_s"] / config["peak_flops"]
