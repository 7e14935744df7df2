"""The share of the learner's minibatches that replayed a CUDA graph: the program's counter `learner.graph_replays`
over its `learner.minibatch` spans, both over the iterations the program's tracer recorded, the profiled ones. 0 where
the program counts no replay; None where it recorded no minibatch, or where the program has no tracer."""


def read(ctx):
    from sample_factory_tpu_torch.utils import timing

    tracer = getattr(timing, "tracer", None)
    if tracer is None:
        return None
    minibatches = sum(1 for s in tracer().spans if s.name == "learner.minibatch")
    replays = sum(c.get("learner.graph_replays", 0) for c in tracer().counters)
    return replays / minibatches if minibatches else None
