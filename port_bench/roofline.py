"""The card's peaks and the least time of the recurrent kernels' work, frozen here as the yardstick.

`bound` and `bwd_bound` are copies of `chip_smoke.py`'s: each input read once and each output written once at the
card's memory bandwidth, against the 2*T*B*G*H*H operations of the recurrent product at the peak of the dtype, the
larger of the two. Times in ms.
"""

from __future__ import annotations

from port_bench import reference

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; float32 outside the tensor cores


def bound(kind, T, B, H, dtype):
    """Least time of the forward recurrence on x_proj [T, B, G*H]: (ms, what bounds it, bytes, operations)."""
    G = 3 if kind == "gru" else 4
    item = 2 if dtype == "bfloat16" else 4
    state = H if kind == "gru" else 2 * H
    nbytes = T * B * G * H * item + B * state * 4 + T * B * 4 + H * G * H * item + T * B * H * 4 + B * state * 4
    if kind == "gru":
        nbytes += G * H * item
    flops = 2 * T * B * H * G * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def bwd_bound(kind, T, B, H, dtype):
    """Least time of the backward recurrence: d_outs, the final state's cotangent, resets, x_proj (the GRU's h_proj and
    h_prev too) or the LSTM's hc0, and wh read once; d_x_proj, the GRU's d_hn and the first state's cotangent written
    once; against the 2*T*B*G*H*H operations of the d_h_proj @ wh^T product."""
    G = 3 if kind == "gru" else 4
    item = 2 if dtype == "bfloat16" else 4
    state = H if kind == "gru" else 2 * H
    wide = T * B * G * H * item
    nbytes = T * B * H * 4 + B * state * 4 + T * B * 4 + H * G * H * item + B * state * 4
    nbytes += 3 * wide + T * B * H * (item + 4) if kind == "gru" else 2 * wide + B * state * 4
    flops = 2 * T * B * G * H * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def learner_rnn_bound_ms(config, epochs: float) -> float:
    """Least time of one train call's recurrent work: `epochs` x minibatches a forward and a backward of each recurrent
    sequence of a minibatch, and, per iteration, a forward of each sequence of a rollout step times the rollout's
    steps. The sequences are those that the configuration's reference module names (`rnn_sites`; `reference/model.py`:
    the one core at (recurrence, batch / recurrence, H) in the configuration's dtype, in the minibatches alone)."""
    f = config["flags"]
    minibatches = config["samples_per_iteration"] // int(f["batch_size"])
    total = 0.0
    for per, kind, T, B, H, dtype in reference.of(config["model"]).rnn_sites(config):
        if per == "minibatch":
            total += epochs * minibatches * (bound(kind, T, B, H, dtype)[0] + bwd_bound(kind, T, B, H, dtype)[0])
        elif per == "rollout_step":
            total += int(f["rollout"]) * bound(kind, T, B, H, dtype)[0]
        else:
            raise ValueError(f"a recurrent sequence {per!r}: neither 'minibatch' nor 'rollout_step'")
    return total
