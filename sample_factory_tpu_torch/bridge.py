"""Parameters of the JAX package's models, carried into the port's modules and back.

The input is the flax parameter tree as a nested dict of numpy arrays (with or
without the top-level "params" key); the output is the port model's
`state_dict`. Mappings:

- Dense `kernel [in, out]` -> `weight [out, in]`;
- Conv `kernel` HWIO -> `weight` OIHW;
- GRU `wi/wh/bi/bh` and LSTM `wi/wh/bi` keep the JAX layout `[in, G*H]`;
- the first Dense after a conv stack: its rows are permuted from the NHWC
  flatten order of the JAX encoder (`models/encoder.py:63`) to the port's
  NCHW flatten order.

Module names follow flax's: `Conv_i` -> `conv.i`, `Dense_i` -> `dense.i`,
`ResBlock_i` -> `resblock.i`, `<tower_>encoder/enc_<key>` ->
`<tower_>encoder.encoders.enc_<key>` (the shared model's `encoder`, the
separate model's `actor_encoder` and `critic_encoder`), and the action head's
`Dense_0` -> `distribution_linear`; its `learned_stddev` keeps its name.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

_LAYER = re.compile(r"(Conv|Dense|ResBlock)_(\d+)")
_FLAX_LAYER = {"conv": "Conv", "dense": "Dense", "resblock": "ResBlock"}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_name(path: Tuple[str, ...]) -> str:
    out = []
    for i, seg in enumerate(path):
        parent = path[i - 1] if i else None
        m = _LAYER.fullmatch(seg)
        if seg == "kernel":
            out.append("weight")
        elif m and parent == "action_parameterization":
            out.append("distribution_linear")
        elif m:
            out += [m.group(1).lower(), m.group(2)]
        elif seg.startswith("enc_") and parent is not None and parent.endswith("encoder"):
            out += ["encoders", seg]
        else:
            out.append(seg)
    return ".".join(out)


def _flax_path(name: str) -> Tuple[str, ...]:
    segs = name.split(".")
    out = []
    i = 0
    while i < len(segs):
        seg = segs[i]
        if seg in _FLAX_LAYER and i + 1 < len(segs) and segs[i + 1].isdigit():
            out.append(f"{_FLAX_LAYER[seg]}_{segs[i + 1]}")
            i += 2
            continue
        if seg == "weight":
            out.append("kernel")
        elif seg == "distribution_linear":
            out.append("Dense_0")
        elif seg != "encoders":
            out.append(seg)
        i += 1
    return tuple(out)


def _conv_owner(model: nn.Module, name: str):
    """The conv or resnet encoder whose first dense layer holds parameter `name`, else None."""
    parts = name.split(".")
    if len(parts) < 4 or parts[-3:-1] != ["dense", "0"]:
        return None
    owner = model.get_submodule(".".join(parts[:-3]))
    return owner if hasattr(owner, "conv_out_hwc") else None


def flax_to_state_dict(flax_params: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree onto `model`'s state_dict names and layouts."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    out = {}
    for path, value in _flatten(flax_params).items():
        name = _torch_name(path)
        if path[-1] == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif path[-1] == "kernel":
            owner = _conv_owner(model, name)
            if owner is not None:
                h, w, c = owner.conv_out_hwc
                value = value.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1)
            value = value.T
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, Any]:
    """Inverse of `flax_to_state_dict`: a nested dict of numpy arrays under "params"."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().float().numpy()
        path = _flax_path(name)
        if path[-1] == "kernel" and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif path[-1] == "kernel":
            value = value.T
            owner = _conv_owner(model, name)
            if owner is not None:
                h, w, c = owner.conv_out_hwc
                value = value.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(h * w * c, -1)
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return {"params": tree}


def load_flax_params(model: nn.Module, flax_params: Dict[str, Any]) -> nn.Module:
    """Copy flax parameters into `model` (strict: every name must match)."""
    model.load_state_dict(flax_to_state_dict(flax_params, model), strict=True)
    return model
