"""One minibatch of the learner (forward, backward, optimizer step): the mean of the program's `learner.minibatch`
spans over the iterations the program's tracer recorded, the profiled ones. None where it recorded none, or where
the program has no tracer."""


def read(ctx):
    from sample_factory_tpu_torch.utils import timing

    tracer = getattr(timing, "tracer", None)
    spans = [s.ms for s in tracer().spans if s.name == "learner.minibatch"] if tracer is not None else []
    return sum(spans) / len(spans) if spans else None
