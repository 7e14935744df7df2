"""Parameters of the JAX package's models, carried into the port's modules and back.

The input is the flax parameter tree as a nested dict of numpy arrays (with or
without the top-level "params" key); the output is the port model's
`state_dict`. Mappings:

- Dense `kernel [in, out]` -> `weight [out, in]`;
- Conv `kernel` HWIO -> `weight` OIHW;
- GRU `wi/wh/bi/bh` and LSTM `wi/wh/bi` keep the JAX layout `[in, G*H]` (the LSTM's
  +1.0 forget offset is inside the gate on both sides, not in `bi`);
- Embed `embedding [num, features]` -> `weight`, unchanged;
- the first Dense after a conv stack: its rows are permuted from the NHWC
  flatten order of the JAX encoder (`models/encoder.py:63`) to the port's
  NCHW flatten order.

Module names follow flax's: `Conv_i` -> `conv.i`, `Dense_i` -> `dense.i`,
`ResBlock_i` -> `resblock.i`, `Embed_i` -> `embed.i`, `FusedLSTMCell_i` -> `fused_lstm.i`
(the examples' encoders; a named layer such as `measurements_fc0` keeps its name),
`<tower_>encoder/enc_<key>` ->
`<tower_>encoder.encoders.enc_<key>` (the shared model's `encoder`, the
separate model's `actor_encoder` and `critic_encoder`), and the action head's
`Dense_0` -> `distribution_linear`; its `learned_stddev` keeps its name.

`load_jax_checkpoint` reads a checkpoint file of the JAX package
(`checkpoint_<train_step>_<env_steps>.msgpack`, written by
`flax.serialization.to_bytes`) without flax or the msgpack package: `unpack_msgpack`
decodes the subset of MessagePack that flax writes.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

_FLAX_LAYER = {"conv": "Conv", "dense": "Dense", "resblock": "ResBlock", "embed": "Embed", "fused_lstm": "FusedLSTMCell"}
_TORCH_LAYER = {v: k for k, v in _FLAX_LAYER.items()}
_LAYER = re.compile(rf"({'|'.join(_TORCH_LAYER)})_(\d+)")


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
        if seg in ("kernel", "embedding"):
            out.append("weight")
        elif m and parent == "action_parameterization":
            out.append("distribution_linear")
        elif m:
            out += [_TORCH_LAYER[m.group(1)], m.group(2)]
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
            out.append("embedding" if out and out[-1].startswith("Embed_") else "kernel")
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


# ------------------------------------------------ checkpoint files of the JAX package

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax.serialization._MsgpackExtType
_CHUNKED = "__msgpack_chunked_array__"  # flax splits arrays above 2**30 bytes into chunks


def _ndarray_from_ext(data: bytes) -> np.ndarray:
    """flax's array payload: MessagePack of (shape, dtype name, C-order bytes)."""
    shape, dtype_name, buffer = unpack_msgpack(data)
    if dtype_name == "bfloat16":  # numpy has no bfloat16: the upper half of a float32
        return (np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def unpack_msgpack(data: bytes) -> Any:
    """Decode one MessagePack object: maps, arrays, strings, ints, floats, nil, booleans, bin,
    and flax's extension types for numpy arrays and scalars. Anything else raises ValueError."""
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated MessagePack data")
        pos += n
        return data[pos - n : pos]

    def number(fmt: str):
        return struct.unpack(">" + fmt, take(struct.calcsize(fmt)))[0]

    def ext(code: int, payload: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray_from_ext(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_ext(payload)[()]
        raise ValueError(f"unsupported MessagePack extension type {code}")

    sized = {  # first byte -> (format of the length, kind)
        0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
        0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
        0xDC: ("H", "array"), 0xDD: ("I", "array"), 0xDE: ("H", "map"), 0xDF: ("I", "map"),
        0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
    }
    numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
    constants = {0xC0: None, 0xC2: False, 0xC3: True}

    def collection(kind: str, n: int):
        if kind == "bin":
            return take(n)
        if kind == "str":
            return take(n).decode("utf-8")
        if kind == "array":
            return [item() for _ in range(n)]
        if kind == "map":
            return {item(): item() for _ in range(n)}
        code = number("b")
        return ext(code, take(n))

    def item():
        b = number("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return collection("map", b & 0x0F)
        if b <= 0x9F:
            return collection("array", b & 0x0F)
        if b <= 0xBF:
            return collection("str", b & 0x1F)
        if b in constants:
            return constants[b]
        if b in numbers:
            return number(numbers[b])
        if b in sized:
            fmt, kind = sized[b]
            return collection(kind, number(fmt))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return collection("ext", 1 << (b - 0xD4))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    out = item()
    if pos != len(data):
        raise ValueError("trailing bytes after the MessagePack object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        return np.concatenate([tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint file of the JAX package. Returns numpy trees and numbers:
    `params` (the flax parameter tree, for `load_flax_params`), `obs_rms` ({key: {running_mean,
    running_var, count}} or None), `returns_rms` (the same three fields or None), `curr_lr`,
    `hparams`, `train_step`, `env_steps`, `best_performance`. The optimizer state (optax's
    moments and counts) is in the file but is not carried: its tree follows optax's chain, not
    a torch optimizer's state."""
    with open(path, "rb") as f:
        payload = _unchunk(unpack_msgpack(f.read()))
    ts = payload["train_state"]
    return {
        "params": ts["params"],
        "obs_rms": ts.get("obs_rms"),
        "returns_rms": ts.get("returns_rms"),
        "curr_lr": float(ts["curr_lr"]),
        "hparams": {k: float(v) for k, v in (ts.get("hparams") or {}).items()},
        "train_step": int(payload["train_step"]),
        "env_steps": int(payload["env_steps"]),
        "best_performance": float(payload["best_performance"]),
    }
