"""The host's wait at its reads of the device an iteration: the program's `sync.<site>` spans added up, averaged
over the iterations the program's tracer recorded, the profiled ones. None where it recorded none, or where the
program has no tracer."""


def read(ctx):
    from sample_factory_tpu_torch.utils import timing

    tracer = getattr(timing, "tracer", None)
    if tracer is None or not tracer().iterations:
        return None
    return sum(s.ms for s in tracer().spans if s.name.startswith("sync.")) / tracer().iterations
