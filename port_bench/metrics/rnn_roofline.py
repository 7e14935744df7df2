"""The least time the profiled iterations' recurrent work could take, over the device time of the kernels that match
`rnn_kernels.d`, in %. The least time is counted from the configuration's shapes (`roofline.learner_rnn_bound_ms`:
the epochs each profiled train call ran x its minibatches, a forward and a backward each), never from the program's
launches."""

from port_bench.roofline import learner_rnn_bound_ms


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["rnn_s"] <= 0:
        return None
    least_ms = sum(learner_rnn_bound_ms(ctx["config"], epochs) for epochs in prof["epochs"])
    return 100.0 * least_ms / (prof["rnn_s"] * 1e3)
