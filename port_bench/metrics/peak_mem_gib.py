"""torch.cuda.max_memory_allocated() over the whole run (set-up, warm-up and window), read when the window closes."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx.get("peak_bytes") else None
