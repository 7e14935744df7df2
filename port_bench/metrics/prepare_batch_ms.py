"""The learner's batch preparation an iteration (normalizers, bootstrap value, GAE, the valid fraction's read): the
program's `learner.prepare_batch` spans added up, averaged over the iterations the program's tracer recorded, the
profiled ones. None where it recorded none, or where the program has no tracer."""


def read(ctx):
    from sample_factory_tpu_torch.utils import timing

    tracer = getattr(timing, "tracer", None)
    if tracer is None or not tracer().iterations:
        return None
    return sum(s.ms for s in tracer().spans if s.name == "learner.prepare_batch") / tracer().iterations
