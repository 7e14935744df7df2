"""Minimal numpy ONNX interpreter — validation engine for exported policies.

A copy of `sample_factory_tpu/onnx/interp.py`: exported graphs are verified
without onnxruntime by executing them with this independent interpreter (numpy
semantics per the ONNX operator spec, opset 13+) and asserting parity against
the policy's forward pass. The op set covers exactly what export_onnx emits."""

from __future__ import annotations

from typing import Dict

import numpy as np

from sample_factory_tpu_torch.onnx import onnx_pb2 as ox

_ONNX_TO_NP = {
    ox.TensorProto.FLOAT: np.float32,
    ox.TensorProto.DOUBLE: np.float64,
    ox.TensorProto.INT32: np.int32,
    ox.TensorProto.INT64: np.int64,
    ox.TensorProto.UINT8: np.uint8,
    ox.TensorProto.BOOL: np.bool_,
}


def tensor_to_np(t: "ox.TensorProto") -> np.ndarray:
    dtype = _ONNX_TO_NP[t.data_type]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dtype)
    elif t.float_data:
        arr = np.asarray(t.float_data, dtype)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dtype)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, dtype)
    else:
        arr = np.zeros(0, dtype)
    return arr.reshape(tuple(t.dims))


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        if a.type == ox.AttributeProto.INT:
            out[a.name] = a.i
        elif a.type == ox.AttributeProto.FLOAT:
            out[a.name] = a.f
        elif a.type == ox.AttributeProto.INTS:
            out[a.name] = list(a.ints)
        elif a.type == ox.AttributeProto.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == ox.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == ox.AttributeProto.TENSOR:
            out[a.name] = tensor_to_np(a.t)
        else:
            raise NotImplementedError(f"attr type {a.type}")
    return out


def _conv2d(x, w, b, strides, pads):
    """x [B, C, H, W], w [O, C, kH, kW], VALID-style explicit pads."""
    pb, pl, pe, pr = pads  # [top, left, bottom, right] per ONNX [x1b, x2b, x1e, x2e]
    if any(pads):
        x = np.pad(x, ((0, 0), (0, 0), (pb, pe), (pl, pr)))
    B, C, H, W = x.shape
    O, _, kH, kW = w.shape
    sh, sw = strides
    oh = (H - kH) // sh + 1
    ow = (W - kW) // sw + 1
    # im2col
    cols = np.empty((B, C, kH, kW, oh, ow), x.dtype)
    for i in range(kH):
        for j in range(kW):
            cols[:, :, i, j] = x[:, :, i : i + sh * oh : sh, j : j + sw * ow : sw]
    cols = cols.reshape(B, C * kH * kW, oh * ow)
    out = np.einsum("ok,bkp->bop", w.reshape(O, C * kH * kW), cols, optimize=True)
    out = out.reshape(B, O, oh, ow)
    if b is not None:
        out = out + b.reshape(1, O, 1, 1)
    return out


def run_model(model_bytes: bytes, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    m = ox.ModelProto()
    m.ParseFromString(model_bytes)
    g = m.graph
    env: Dict[str, np.ndarray] = {}
    for init in g.initializer:
        env[init.name] = tensor_to_np(init)
    for vi in g.input:
        if vi.name not in env:
            env[vi.name] = np.asarray(feeds[vi.name])

    for node in g.node:
        op = node.op_type
        a = _attrs(node)
        x = [env[i] for i in node.input if i]

        if op == "Gemm":
            A, B = x[0], x[1]
            if a.get("transA"):
                A = A.T
            if a.get("transB"):
                B = B.T
            y = a.get("alpha", 1.0) * (A @ B)
            if len(x) > 2:
                y = y + a.get("beta", 1.0) * x[2]
        elif op == "MatMul":
            y = x[0] @ x[1]
        elif op == "Add":
            y = x[0] + x[1]
        elif op == "Sub":
            y = x[0] - x[1]
        elif op == "Mul":
            y = x[0] * x[1]
        elif op == "Div":
            y = x[0] / x[1]
        elif op == "Relu":
            y = np.maximum(x[0], 0)
        elif op == "Elu":
            alpha = a.get("alpha", 1.0)
            y = np.where(x[0] > 0, x[0], alpha * (np.exp(np.minimum(x[0], 0.0)) - 1.0)).astype(x[0].dtype)
        elif op == "Tanh":
            y = np.tanh(x[0])
        elif op == "Sigmoid":
            y = (1.0 / (1.0 + np.exp(-x[0]))).astype(x[0].dtype)
        elif op == "Clip":
            lo = x[1] if len(x) > 1 else -np.inf
            hi = x[2] if len(x) > 2 else np.inf
            y = np.clip(x[0], lo, hi)
        elif op == "Concat":
            y = np.concatenate(x, axis=a["axis"])
        elif op == "Reshape":
            # dim 0 = copy the corresponding input dim (ONNX Reshape semantics)
            dims = [int(x[0].shape[i]) if int(d) == 0 else int(d) for i, d in enumerate(x[1])]
            y = x[0].reshape(dims)
        elif op == "Transpose":
            y = np.transpose(x[0], a["perm"])
        elif op == "Identity":
            y = x[0]
        elif op == "Cast":
            y = x[0].astype(_ONNX_TO_NP[a["to"]])
        elif op == "ArgMax":
            axis = a.get("axis", 0)
            y = np.argmax(x[0], axis=axis).astype(np.int64)
            if a.get("keepdims", 1):
                y = np.expand_dims(y, axis)
        elif op == "Slice":
            starts, ends, axes = x[1], x[2], x[3]
            sl = [slice(None)] * x[0].ndim
            for s, e, ax in zip(starts, ends, axes):
                sl[int(ax)] = slice(int(s), None if int(e) >= np.iinfo(np.int32).max else int(e))
            y = x[0][tuple(sl)]
        elif op == "Split":
            axis = a.get("axis", 0)
            parts = len(node.output)
            pieces = np.split(x[0], parts, axis=axis)
            for name, piece in zip(node.output, pieces):
                env[name] = piece
            continue
        elif op == "Conv":
            strides = a.get("strides", [1, 1])
            pads = a.get("pads", [0, 0, 0, 0])
            assert a.get("group", 1) == 1 and all(d == 1 for d in a.get("dilations", [1, 1]))
            y = _conv2d(x[0], x[1], x[2] if len(x) > 2 else None, strides, pads)
        else:
            raise NotImplementedError(f"op {op}")

        env[node.output[0]] = y

    return {vi.name: env[vi.name] for vi in g.output}
