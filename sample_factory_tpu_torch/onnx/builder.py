"""Tiny ONNX graph builder over the transcribed IR schema (onnx.proto).

Emits spec-conformant ModelProto files (opset 17, ir_version 8) without
requiring the `onnx` python package (a copy of `sample_factory_tpu/onnx/builder.py`).
Wire compatibility holds because protobuf serialization depends only on field
numbers, which the ONNX IR spec freezes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from sample_factory_tpu_torch.onnx import onnx_pb2 as ox

_NP_TO_ONNX = {
    np.dtype(np.float32): ox.TensorProto.FLOAT,
    np.dtype(np.float64): ox.TensorProto.DOUBLE,
    np.dtype(np.int32): ox.TensorProto.INT32,
    np.dtype(np.int64): ox.TensorProto.INT64,
    np.dtype(np.uint8): ox.TensorProto.UINT8,
    np.dtype(np.bool_): ox.TensorProto.BOOL,
}

FLOAT = ox.TensorProto.FLOAT
INT32 = ox.TensorProto.INT32
INT64 = ox.TensorProto.INT64


def _tensor_proto(name: str, arr: np.ndarray) -> "ox.TensorProto":
    arr = np.ascontiguousarray(arr)
    t = ox.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    t.data_type = _NP_TO_ONNX[arr.dtype]
    t.raw_data = arr.tobytes()
    return t


def _value_info(name: str, shape: Sequence[Union[int, str]], elem_type: int) -> "ox.ValueInfoProto":
    vi = ox.ValueInfoProto()
    vi.name = name
    vi.type.tensor_type.elem_type = elem_type
    for d in shape:
        dim = vi.type.tensor_type.shape.dim.add()
        if isinstance(d, str):
            dim.dim_param = d
        else:
            dim.dim_value = int(d)
    return vi


class OnnxGraphBuilder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[ox.NodeProto] = []
        self.initializers: List[ox.TensorProto] = []
        self.inputs: List[ox.ValueInfoProto] = []
        self.outputs: List[ox.ValueInfoProto] = []
        self._n = 0

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add_input(self, name: str, shape, elem_type: int = FLOAT) -> str:
        self.inputs.append(_value_info(name, shape, elem_type))
        return name

    def add_output(self, name: str, shape, elem_type: int = FLOAT) -> str:
        self.outputs.append(_value_info(name, shape, elem_type))
        return name

    def init(self, arr: np.ndarray, hint: str = "w") -> str:
        name = self.fresh(hint)
        self.initializers.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1, hint: Optional[str] = None, **attrs):
        """Append a node; returns its output name (or tuple of names)."""
        n = ox.NodeProto()
        n.op_type = op
        n.name = self.fresh(f"node_{op}")
        n.input.extend(inputs)
        outs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        n.output.extend(outs)
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, bool):
                a.type = ox.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, int):
                a.type = ox.AttributeProto.INT
                a.i = v
            elif isinstance(v, float):
                a.type = ox.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, str):
                a.type = ox.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)) and all(isinstance(x, int) for x in v):
                a.type = ox.AttributeProto.INTS
                a.ints.extend(v)
            elif isinstance(v, (list, tuple)) and all(isinstance(x, float) for x in v):
                a.type = ox.AttributeProto.FLOATS
                a.floats.extend(v)
            elif isinstance(v, np.ndarray):
                a.type = ox.AttributeProto.TENSOR
                a.t.CopyFrom(_tensor_proto(self.fresh("attr_t"), v))
            else:
                raise TypeError(f"unsupported attribute {k}={v!r}")
        self.nodes.append(n)
        return outs[0] if n_out == 1 else tuple(outs)

    # ------------------------------------------------------- common patterns

    def const(self, arr: np.ndarray, hint: str = "c") -> str:
        return self.init(np.asarray(arr), hint=hint)

    def gemm(self, x: str, kernel: np.ndarray, bias: Optional[np.ndarray]) -> str:
        """x [B, in] @ kernel [in, out] + bias [out]."""
        w = self.init(np.asarray(kernel, np.float32), "kernel")
        ins = [x, w]
        if bias is not None:
            ins.append(self.init(np.asarray(bias, np.float32), "bias"))
        return self.node("Gemm", ins, hint="gemm")

    def activation(self, x: str, kind: str) -> str:
        op = {"relu": "Relu", "elu": "Elu", "tanh": "Tanh"}[kind]
        return self.node(op, [x], hint=kind)

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        s = self.init(np.asarray(shape, np.int64), "shape")
        return self.node("Reshape", [x, s], hint="reshape")

    def clip(self, x: str, lo: float, hi: float) -> str:
        lo_t = self.init(np.asarray(lo, np.float32), "clip_lo")
        hi_t = self.init(np.asarray(hi, np.float32), "clip_hi")
        return self.node("Clip", [x, lo_t, hi_t], hint="clip")

    def slice(self, x: str, starts: Sequence[int], ends: Sequence[int], axes: Sequence[int]) -> str:
        s = self.init(np.asarray(starts, np.int64), "starts")
        e = self.init(np.asarray(ends, np.int64), "ends")
        a = self.init(np.asarray(axes, np.int64), "axes")
        return self.node("Slice", [x, s, e, a], hint="slice")

    def model_bytes(self, opset: int = 17, doc: str = "") -> bytes:
        g = ox.GraphProto()
        g.name = self.name
        g.node.extend(self.nodes)
        g.initializer.extend(self.initializers)
        g.input.extend(self.inputs)
        g.output.extend(self.outputs)
        m = ox.ModelProto()
        m.ir_version = 8
        m.producer_name = "sample_factory_tpu"
        m.producer_version = "1.0"
        m.doc_string = doc
        m.graph.CopyFrom(g)
        op = m.opset_import.add()
        op.domain = ""
        op.version = opset
        return m.SerializeToString()
