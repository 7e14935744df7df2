"""Env steps of every whole iteration completed in the window, over the window's time; both ends synchronized."""


def read(ctx):
    return ctx["window_env_steps"] / ctx["window_s"] if ctx.get("window_s") else None
