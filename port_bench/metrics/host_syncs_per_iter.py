"""Host syncs an iteration: the program's counter `host_syncs` (one for each `tracer().host_read`, a read of the
device that drains the launch queue), averaged over the iterations the program's tracer recorded, the profiled ones.
None where it recorded none, or where the program has no tracer."""


def read(ctx):
    from sample_factory_tpu_torch.utils import timing

    tracer = getattr(timing, "tracer", None)
    counters = tracer().counters if tracer is not None else []
    return sum(c.get("host_syncs", 0) for c in counters) / len(counters) if counters else None
