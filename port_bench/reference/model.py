"""The actor-critic of a configuration, as plain functions of a dict of leaves.

The leaves carry the names and layouts of the trained model's state dict, so that the benchmark can hand the same
weights to both sides: a Dense weight is [out, in], a conv weight [out, in, k, k], a recurrent cell's `wi` [in, G*H],
`wh` [H, G*H] with the GRU's gates [r, z, n] and the LSTM's [i, f, g, o] (forget bias 1.0, no recurrent bias); the
recurrent state is h (GRU) or h || c (LSTM). Observations are channel-last images or flat vectors under one key,
`obs_key`, of the dict of observations. The module's interface is `reference/__init__.py`'s.

`Precision` says how every product is computed: "float32" (IEEE, TF32 off: the reference), "tf32" (TF32 on: the
control of a float32 configuration), "float8" (each operand of every product rounded to float8 e4m3 with a scale of
its own, accumulated in float32: the control of a bfloat16 configuration), "float64" (every product in float64,
rounded to float32 after: a second witness, as right as the reference, whose gaps show what rounding alone makes of a
number) or "exact" (the whole reference in float64, weights, inputs, state and every operation: the witness that says
which of two float32 answers lies nearer the exact one).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

CONV_FILTERS = {  # (out channels, kernel, stride), VALID padding
    "convnet_simple": [(32, 8, 4), (64, 4, 2), (128, 3, 2)],
    "convnet_impala": [(16, 8, 4), (32, 4, 2)],
    "convnet_atari": [(32, 8, 4), (64, 4, 2), (64, 3, 1)],
}
FLOAT8_MAX = 448.0  # largest finite float8 e4m3fn
STDDEV_MIN, STDDEV_MAX = 1e-4, 1e4


class Precision:
    def __init__(self, name: str = "float32"):
        assert name in ("float32", "tf32", "float8", "float64", "exact"), name
        self.name = name
        self.dtype = torch.float64 if name == "exact" else torch.float32

    @contextlib.contextmanager
    def active(self):
        """TF32 on for "tf32", off otherwise, restored after."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name != "float8":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FLOAT8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()  # rounded forward, the gradient passes straight through

    def matmul(self, x, w):
        if self.name == "float64":
            return (x.double() @ w.double()).float()
        return self.operand(x) @ self.operand(w)

    def linear(self, x, w, b):
        if self.name == "float64":
            return F.linear(x.double(), w.double(), b.double()).float()
        return F.linear(self.operand(x), self.operand(w), b)

    def conv(self, x, w, b, stride):
        if self.name == "float64":
            return F.conv2d(x.double(), w.double(), b.double(), stride=stride).float()
        return F.conv2d(self.operand(x), self.operand(w), b, stride=stride)


def _act(name):
    return {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh}[name]


def encoder_layers(model: Dict) -> Tuple[List[Tuple[str, Tuple[int, ...], int]], int]:
    """(leaves of the encoder as (name, shape, fan_in), its output width)."""
    enc = model["encoder"]
    prefix = f"encoder.encoders.enc_{model['obs_key']}"
    leaves = []
    if enc["type"] == "mlp":
        width = enc["obs_dim"]
    else:
        h, w, c = enc["obs_hwc"]
        for i, (out, k, s) in enumerate(CONV_FILTERS[enc["conv"]]):
            leaves += [(f"{prefix}.conv.{i}.weight", (out, c, k, k), c * k * k), (f"{prefix}.conv.{i}.bias", (out,), 0)]
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, out
        width = h * w * c
    for i, size in enumerate(enc["layers"]):
        leaves += [(f"{prefix}.dense.{i}.weight", (size, width), width), (f"{prefix}.dense.{i}.bias", (size,), 0)]
        width = size
    return leaves, width


def leaf_specs(model: Dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """Every trained leaf as (name, shape, fan_in), fan_in 0 for a leaf that starts at zero."""
    leaves, width = encoder_layers(model)
    core, H = model["core"]["type"], model["core"]["size"]
    G = {"gru": 3, "lstm": 4}[core] * H
    leaves += [(f"core.{core}_0.wi", (width, G), width), (f"core.{core}_0.wh", (H, G), H), (f"core.{core}_0.bi", (G,), 0)]
    if core == "gru":
        leaves.append((f"core.{core}_0.bh", (G,), 0))
    leaves += [("critic_linear.weight", (1, H), H), ("critic_linear.bias", (1,), 0)]
    act = model["action"]
    if act["type"] == "gaussian":
        leaves += [("action_parameterization.distribution_linear.weight", (act["dim"], H), H),
                   ("action_parameterization.distribution_linear.bias", (act["dim"],), 0),
                   ("action_parameterization.learned_stddev", (act["dim"],), 0)]
    else:
        leaves += [("action_parameterization.distribution_linear.weight", (act["n"], H), H),
                   ("action_parameterization.distribution_linear.bias", (act["n"],), 0)]
    return leaves


def make_leaves(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from the seed, on the device, in one draw: each weight N(0, 1/fan_in), every bias 0, the Gaussian's
    log-stddev at log(initial_stddev)."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [s for s in specs if s[2] > 0]
    flat = torch.randn(sum(math.prod(shape) for _, shape, _ in drawn), generator=gen, device=device)
    leaves, at = {}, 0
    for name, shape, fan_in in specs:
        if fan_in > 0:
            n = math.prod(shape)
            leaves[name] = (flat[at : at + n] / math.sqrt(fan_in)).reshape(shape)
            at += n
        elif name.endswith("learned_stddev"):
            leaves[name] = torch.full(shape, math.log(model["action"]["initial_stddev"]), device=device)
        else:
            leaves[name] = torch.zeros(shape, device=device)
    return leaves


def encode(p, model: Dict, obs: Dict[str, torch.Tensor], prec: Precision) -> torch.Tensor:
    """obs[obs_key] [..., obs_dim] or [..., H, W, C] (normalized) -> [..., D]."""
    enc, act = model["encoder"], _act(model["nonlinearity"])
    prefix = f"encoder.encoders.enc_{model['obs_key']}"
    x = obs[model["obs_key"]].to(prec.dtype)
    if enc["type"] == "conv":
        batch = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        for i, (_, _, s) in enumerate(CONV_FILTERS[enc["conv"]]):
            x = act(prec.conv(x, p[f"{prefix}.conv.{i}.weight"], p[f"{prefix}.conv.{i}.bias"], s))
        x = x.reshape(batch + (-1,))
    for i in range(len(enc["layers"])):
        x = act(prec.linear(x, p[f"{prefix}.dense.{i}.weight"], p[f"{prefix}.dense.{i}.bias"]))
    return x


def state_width(model: Dict) -> int:
    return model["core"]["size"] * (2 if model["core"]["type"] == "lstm" else 1)


def cell(p, model: Dict, x_proj: torch.Tensor, state: torch.Tensor, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step from the input part x_proj = x @ wi + bi: (output h, new state)."""
    core = model["core"]["type"]
    wh = p[f"core.{core}_0.wh"]
    if core == "gru":
        h_proj = prec.matmul(state, wh) + p[f"core.{core}_0.bh"]
        xr, xz, xn = x_proj.chunk(3, dim=-1)
        hr, hz, hn = h_proj.chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * state
        return h, h
    H = model["core"]["size"]
    h, c = state[:, :H], state[:, H:]
    i, f, g, o = (x_proj + prec.matmul(h, wh)).chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, torch.cat([h, c], dim=-1)


def input_part(p, model: Dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    core = model["core"]["type"]
    return prec.matmul(x, p[f"core.{core}_0.wi"]) + p[f"core.{core}_0.bi"]


def heads(p, model: Dict, h: torch.Tensor, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action parameters, values) of core outputs."""
    values = prec.linear(h, p["critic_linear.weight"], p["critic_linear.bias"])[..., 0]
    out = prec.linear(h, p["action_parameterization.distribution_linear.weight"],
                      p["action_parameterization.distribution_linear.bias"])
    if model["action"]["type"] == "gaussian":
        out = torch.cat([out, p["action_parameterization.learned_stddev"].expand_as(out)], dim=-1)
    return out, values


def policy_step(p, model: Dict, obs: Dict[str, torch.Tensor], state: torch.Tensor, prec: Precision):
    """One rollout step over [N] envs: (action parameters, values, new state)."""
    h, new_state = cell(p, model, input_part(p, model, encode(p, model, obs, prec), prec), state, prec)
    params, values = heads(p, model, h, prec)
    return params, values, new_state


def forward_seq(p, model: Dict, obs: Dict[str, torch.Tensor], state0: torch.Tensor, resets: torch.Tensor, prec: Precision):
    """BPTT over segments: obs [S, R, ...] a key, state0 [S, state], resets [S, R] (the state is zeroed after step t where
    resets[:, t]) -> (action parameters [S*R, P], values [S*R])."""
    S, R = resets.shape
    x = input_part(p, model, encode(p, model, obs, prec), prec)  # [S, R, G]
    state, outs = state0, []
    for t in range(R):
        h, state = cell(p, model, x[:, t], state, prec)
        outs.append(h)
        state = torch.where(resets[:, t, None] > 0, torch.zeros_like(state), state)
    return heads(p, model, torch.stack(outs, dim=1).reshape(S * R, -1), prec)


# ------------------------------------------------------------------ action distributions


def log_prob(model: Dict, params: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    if model["action"]["type"] == "gaussian":
        d = params.shape[-1] // 2
        means, std = params[..., :d], params[..., d:].exp().clamp(STDDEV_MIN, STDDEV_MAX)
        lp = -0.5 * (actions - means).square() / std.square() - std.log() - 0.5 * math.log(2 * math.pi)
        return lp.sum(dim=-1)
    return F.log_softmax(params, dim=-1).gather(-1, actions[..., :1].long())[..., 0]


def entropy(model: Dict, params: torch.Tensor) -> torch.Tensor:
    if model["action"]["type"] == "gaussian":
        d = params.shape[-1] // 2
        std = params[..., d:].exp().clamp(STDDEV_MIN, STDDEV_MAX)
        return (0.5 + 0.5 * math.log(2 * math.pi) + std.log()).sum(dim=-1)
    logp = F.log_softmax(params, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def kl(model: Dict, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """KL(new || old) of each row."""
    if model["action"]["type"] == "gaussian":
        d = new.shape[-1] // 2
        m1, s1 = new[..., :d], new[..., d:].exp().clamp(STDDEV_MIN, STDDEV_MAX)
        m0, s0 = old[..., :d], old[..., d:].exp().clamp(STDDEV_MIN, STDDEV_MAX)
        return ((s0 / s1).log() + (s1.square() + (m1 - m0).square()) / (2.0 * s0.square()) - 0.5).sum(dim=-1)
    lp1, lp0 = F.log_softmax(new, dim=-1), F.log_softmax(old, dim=-1)
    return (lp1.exp() * (lp1 - lp0)).sum(dim=-1)


# ------------------------------------------------------------------ counts (`flops.py`, `roofline.py`)


def encoder_flops(model: Dict) -> Tuple[int, int]:
    """2 x the multiply-adds of the encoder over one sample, and its output width."""
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
    return flops, width


def core_flops(model: Dict, width: int) -> int:
    """One step of the recurrent cell over an input of `width`: its input and recurrent products."""
    H = model["core"]["size"]
    G = {"gru": 3, "lstm": 4}[model["core"]["type"]] * H
    return 2 * width * G + 2 * H * G


def head_flops(model: Dict, width: int) -> int:
    """The critic and the action head over a feature of `width`."""
    act = model["action"]
    return 2 * width * 1 + 2 * width * (act["dim"] if act["type"] == "gaussian" else act["n"])


def forward_flops_per_sample(model: Dict) -> int:
    flops, width = encoder_flops(model)
    return flops + core_flops(model, width) + head_flops(model, model["core"]["size"])


def rnn_sites(config: Dict) -> List[Tuple]:
    """The core, a forward and a backward in each minibatch at (recurrence, batch / recurrence, H) in the
    configuration's dtype."""
    f, core = config["flags"], config["model"]["core"]
    T = int(f["recurrence"])
    return [("minibatch", core["type"], T, int(f["batch_size"]) // T, core["size"], f["compute_dtype"])]
