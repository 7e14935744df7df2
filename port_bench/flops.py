"""Model flops, counted from a configuration's widths alone: 2 x the multiply-adds of every product of one forward of
one sample (the encoder's layers, the recurrent cell's input and recurrent products, the critic and the action head).
Nothing is read from the program's modules, and nothing recomputed is counted."""

from __future__ import annotations

from port_bench.reference.model import CONV_FILTERS


def forward_flops_per_sample(model) -> int:
    enc = model["encoder"]
    flops = 0
    if enc["type"] == "mlp":
        width = enc["obs_dim"]
    else:
        h, w, c = enc["obs_hwc"]
        for out, k, s in CONV_FILTERS[enc["conv"]]:
            h, w = (h - k) // s + 1, (w - k) // s + 1
            flops += 2 * h * w * out * c * k * k
            c = out
        width = h * w * c
    for size in enc["layers"]:
        flops += 2 * width * size
        width = size
    H = model["core"]["size"]
    G = {"gru": 3, "lstm": 4}[model["core"]["type"]] * H
    flops += 2 * width * G + 2 * H * G
    act = model["action"]
    flops += 2 * H * 1 + 2 * H * (act["dim"] if act["type"] == "gaussian" else act["n"])
    return flops


def model_flops_per_env_step(model, rollout: int, epochs: float) -> float:
    """A rollout forward, the bootstrap value's share (1 / rollout) and a forward and backward (3 forwards) an epoch."""
    return forward_flops_per_sample(model) * (1.0 + 1.0 / rollout + 3.0 * epochs)
