"""Device time of the kernels that match `rnn_kernels.d`, per profiled iteration."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["rnn_s"] <= 0:
        return None
    return prof["rnn_s"] * 1e3 / prof["iterations"]
