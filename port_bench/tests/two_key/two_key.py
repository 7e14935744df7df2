"""The plain reference of the test configuration `two_key`, a model of the port's default multi-input form: each
observation key in sorted order through an encoder of its own (`reference/model.py`'s, a conv stack and Dense layers
over a channel-last image, or Dense layers over a flat vector: here int32 ids taken as numbers), the encodings joined,
then `reference/model.py`'s core (or none: `core.type` "none") and heads; its counts are `reference/model.py`'s,
key by key."""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference import model as base
from port_bench.reference.model import entropy, kl, log_prob  # noqa: F401 (the module's interface)


def _one(model: Dict, key: str) -> Dict:
    """The model block of one key's encoder, in `reference/model.py`'s form."""
    return {"obs_key": key, "encoder": model["encoder"][key], "nonlinearity": model["nonlinearity"]}


def _has_core(model: Dict) -> bool:
    return model["core"]["type"] != "none"


def state_width(model: Dict) -> int:
    return base.state_width(model) if _has_core(model) else 0


def make_leaves(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """As `reference/model.py`: each weight N(0, 1/fan_in) from one draw, every bias 0."""
    specs, width = [], 0
    for key in sorted(model["encoder"]):
        leaves, out = base.encoder_layers(_one(model, key))
        specs, width = specs + leaves, width + out
    if _has_core(model):
        core, H = model["core"]["type"], model["core"]["size"]
        G = {"gru": 3, "lstm": 4}[core] * H
        specs += [(f"core.{core}_0.wi", (width, G), width), (f"core.{core}_0.wh", (H, G), H),
                  (f"core.{core}_0.bi", (G,), 0)] + ([(f"core.{core}_0.bh", (G,), 0)] if core == "gru" else [])
        width = H
    n = model["action"]["n"]
    specs += [("critic_linear.weight", (1, width), width), ("critic_linear.bias", (1,), 0),
              ("action_parameterization.distribution_linear.weight", (n, width), width),
              ("action_parameterization.distribution_linear.bias", (n,), 0)]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, f in specs if f > 0), generator=gen, device=device)
    leaves, at = {}, 0
    for name, shape, fan_in in specs:
        if fan_in > 0:
            leaves[name] = (flat[at : at + math.prod(shape)] / math.sqrt(fan_in)).reshape(shape)
            at += math.prod(shape)
        else:
            leaves[name] = torch.zeros(shape, device=device)
    return leaves


def encode(p, model: Dict, obs: Dict[str, torch.Tensor], prec) -> torch.Tensor:
    return torch.cat([base.encode(p, _one(model, key), obs, prec) for key in sorted(model["encoder"])], dim=-1)


def policy_step(p, model: Dict, obs: Dict[str, torch.Tensor], state: torch.Tensor, prec):
    x = encode(p, model, obs, prec)
    if _has_core(model):
        x, state = base.cell(p, model, base.input_part(p, model, x, prec), state, prec)
    params, values = base.heads(p, model, x, prec)
    return params, values, state


def forward_seq(p, model: Dict, obs: Dict[str, torch.Tensor], state0: torch.Tensor, resets: torch.Tensor, prec):
    S, R = resets.shape
    x = encode(p, model, obs, prec)  # [S, R, D]
    if not _has_core(model):
        return base.heads(p, model, x.reshape(S * R, -1), prec)
    x = base.input_part(p, model, x, prec)
    state, outs = state0, []
    for t in range(R):
        h, state = base.cell(p, model, x[:, t], state, prec)
        outs.append(h)
        state = torch.where(resets[:, t, None] > 0, torch.zeros_like(state), state)
    return base.heads(p, model, torch.stack(outs, dim=1).reshape(S * R, -1), prec)


def forward_flops_per_sample(model: Dict) -> int:
    flops, width = 0, 0
    for key in sorted(model["encoder"]):
        f, w = base.encoder_flops(_one(model, key))
        flops, width = flops + f, width + w
    if _has_core(model):
        flops, width = flops + base.core_flops(model, width), model["core"]["size"]
    return flops + base.head_flops(model, width)


def rnn_sites(config: Dict):
    return base.rnn_sites(config) if _has_core(config["model"]) else []
