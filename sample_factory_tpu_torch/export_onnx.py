"""Direct ONNX export of a trained policy, built by hand without `torch.onnx`.

Counterpart of `sample_factory_tpu/export_onnx.py` (`build_policy_onnx` :225-280
and its helpers :42-222, `export_policy_onnx` :283, `main` :318; reference
`sample_factory/export_onnx.py:26-100`). `torch.onnx.export` needs the `onnx`
package (and its newer exporter `onnxscript`), so, as the JAX package does, this
module builds the ONNX graph from the parameters itself (`onnx/builder.py`) and
checks it with a numpy interpreter (`onnx/interp.py`).

The port's `state_dict` is first turned into the flax parameter tree by
`bridge.state_dict_to_flax` (which undoes the row permutation of the first Dense
after a conv stack; bf16 parameters come out as float32), and the graph is then
walked exactly as the JAX exporter walks that tree: NHWC inputs transposed around
each conv, the GRU's [r, z, n] gates, the LSTM with +1 on the forget gate and no
recurrent bias, both action heads and the mask. The graph therefore takes the
same input tensors (names, NHWC layout, shapes) as the JAX exporter's.

The exported function matches `export_model.build_inference_fn` with
deterministic=True:

    (obs..., [action_mask], rnn_state) -> (actions, new_rnn_state)

Refused (NotImplementedError), as in the JAX package: resnet encoders, custom
models, action masks on tuple spaces. No sampling is mapped: the graph is the
deterministic policy. The protobuf module is
imported inside the functions, so that this module imports where protobuf is
missing.
"""

from __future__ import annotations

import sys
from os.path import join
from typing import Any, Dict, Optional

import numpy as np

from sample_factory_tpu_torch.envs.spaces import (
    Discrete,
    TupleSpec,
    is_continuous_action_space,
    num_action_parameters,
    num_actions,
    obs_space_as_dict,
)
from sample_factory_tpu_torch.models.encoder import CONV_FILTERS
from sample_factory_tpu_torch.utils.utils import experiment_dir, log


def _build_preprocess(b, cfg, key: str, x: str) -> str:
    """_static_preprocess (algo/sampling.py:76): sub/scale on the "obs" key."""
    if key == "obs":
        if cfg.obs_subtract_mean != 0.0:
            x = b.node("Sub", [x, b.const(np.float32(cfg.obs_subtract_mean), "sub_mean")])
        if cfg.obs_scale != 1.0:
            x = b.node("Div", [x, b.const(np.float32(cfg.obs_scale), "scale")])
    return x


def _build_normalize(b, rms_state, x: str) -> str:
    """rms_normalize: clip((x - mean) / sqrt(var + eps), +-clip)."""
    mean = rms_state.running_mean.detach().cpu().float().numpy()
    sigma = np.sqrt(rms_state.running_var.detach().cpu().float().numpy() + rms_state.eps).astype(np.float32)
    if rms_state.norm_only:
        return b.node("Div", [x, b.const(sigma, "rms_sigma")])
    y = b.node("Sub", [x, b.const(mean, "rms_mean")])
    y = b.node("Div", [y, b.const(sigma, "rms_sigma")])
    return b.clip(y, -float(rms_state.clip), float(rms_state.clip))


def _dense_stack(b, cfg, params: Dict[str, Any], x: str) -> str:
    """Sequential Dense_i + nonlinearity (Mlp encoder/decoder, conv MLP tail)."""
    i = 0
    while f"Dense_{i}" in params:
        d = params[f"Dense_{i}"]
        x = b.gemm(x, d["kernel"], d.get("bias"))
        x = b.activation(x, cfg.nonlinearity)
        i += 1
    return x


def _build_conv_encoder(b, cfg, params: Dict[str, Any], x: str) -> str:
    """ConvEncoder: VALID convolutions over an NHWC input, flattened in NHWC order (the
    flax tree's first Dense expects that order), then the conv MLP."""
    arch = cfg.encoder_conv_architecture
    if arch not in CONV_FILTERS:
        raise NotImplementedError(f"ONNX export: unsupported conv architecture {arch} (resnet not mapped)")
    x = b.node("Transpose", [x], perm=[0, 3, 1, 2])  # NHWC -> NCHW
    for i, (_out_ch, kernel, stride) in enumerate(CONV_FILTERS[arch]):
        cp = params[f"Conv_{i}"]
        w = np.asarray(cp["kernel"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        ins = [x, b.init(w, f"conv_w{i}")]
        if "bias" in cp:
            ins.append(b.init(np.asarray(cp["bias"], np.float32), f"conv_b{i}"))
        x = b.node("Conv", ins, strides=[stride, stride], pads=[0, 0, 0, 0], kernel_shape=[kernel, kernel])
        x = b.activation(x, cfg.nonlinearity)
    x = b.node("Transpose", [x], perm=[0, 2, 3, 1])  # back to NHWC
    x = b.reshape(x, [0, -1])  # [B, H*W*C], 0 = copy batch dim
    return _dense_stack(b, cfg, params, x)


def _build_encoder(b, cfg, enc_params: Dict[str, Any], obs_spec, normalized: Dict[str, str]) -> str:
    """MultiInputEncoder: per-key encoder, sorted keys, concat."""
    encodings = []
    for key in sorted(obs_spec.keys()):
        if key == "action_mask":
            continue
        sub = enc_params[f"enc_{key}"]
        if len(obs_spec[key].shape) == 1:
            encodings.append(_dense_stack(b, cfg, sub, normalized[key]))
        else:
            encodings.append(_build_conv_encoder(b, cfg, sub, normalized[key]))
    if len(encodings) == 1:
        return encodings[0]
    return b.node("Concat", encodings, axis=1)


def _gru_step(b, cell: Dict[str, Any], x: str, h: str) -> str:
    """FusedGRUCell single step (ops/rnn_cells.py), gate layout [r,z,n]."""
    x_proj = b.gemm(x, cell["wi"], cell["bi"])
    h_proj = b.gemm(h, cell["wh"], cell["bh"])
    xr, xz, xn = b.node("Split", [x_proj], n_out=3, axis=1)
    hr, hz, hn = b.node("Split", [h_proj], n_out=3, axis=1)
    r = b.node("Sigmoid", [b.node("Add", [xr, hr])])
    z = b.node("Sigmoid", [b.node("Add", [xz, hz])])
    n = b.node("Tanh", [b.node("Add", [xn, b.node("Mul", [r, hn])])])
    one = b.const(np.float32(1.0), "one")
    return b.node("Add", [b.node("Mul", [b.node("Sub", [one, z]), n]), b.node("Mul", [z, h])])


def _lstm_step(b, cell: Dict[str, Any], x: str, h: str, c: str):
    """FusedLSTMCell single step: gate layout [i,f,g,o], forget offset +1.0, no recurrent bias."""
    proj = b.node("Add", [b.gemm(x, cell["wi"], cell["bi"]), b.node("MatMul", [h, b.init(np.asarray(cell["wh"], np.float32), "wh")])])
    i, f, g, o = b.node("Split", [proj], n_out=4, axis=1)
    one = b.const(np.float32(1.0), "one")
    new_c = b.node(
        "Add",
        [
            b.node("Mul", [b.node("Sigmoid", [b.node("Add", [f, one])]), c]),
            b.node("Mul", [b.node("Sigmoid", [i]), b.node("Tanh", [g])]),
        ],
    )
    new_h = b.node("Mul", [b.node("Sigmoid", [o]), b.node("Tanh", [new_c])])
    return new_h, new_c


def _build_core(b, cfg, core_params: Optional[Dict[str, Any]], x: str, rnn_in: str, rnn_offset: int):
    """ModelCoreRNN: layered GRU/LSTM over the flat state chunk starting at rnn_offset
    (separate-weights towers use halves)."""
    if not cfg.use_rnn:
        return x, []
    size = cfg.rnn_size
    is_lstm = cfg.rnn_type == "lstm"
    per_layer = size * (2 if is_lstm else 1)
    new_chunks = []
    inp = x
    for layer in range(cfg.rnn_num_layers):
        lo = rnn_offset + layer * per_layer
        cell = core_params[("lstm_" if is_lstm else "gru_") + str(layer)]
        if is_lstm:
            h = b.slice(rnn_in, [lo], [lo + size], [1])
            c = b.slice(rnn_in, [lo + size], [lo + 2 * size], [1])
            new_h, new_c = _lstm_step(b, cell, inp, h, c)
            new_chunks.append(b.node("Concat", [new_h, new_c], axis=1))
        else:
            new_h = _gru_step(b, cell, inp, b.slice(rnn_in, [lo], [lo + per_layer], [1]))
            new_chunks.append(new_h)
        inp = new_h
    return inp, new_chunks


def _build_action_head(b, cfg, env_info, ap_params: Dict[str, Any], decoded: str, mask: Optional[str]):
    from sample_factory_tpu_torch.onnx import onnx_pb2 as ox

    space = env_info.action_space
    d = ap_params["Dense_0"]
    logits = b.gemm(decoded, d["kernel"], d.get("bias"))
    if is_continuous_action_space(space):
        n = int(np.asarray(d["kernel"]).shape[1])
        if not cfg.adaptive_stddev:
            ts = cfg.continuous_tanh_scale
            if ts > 0:
                logits = b.node("Mul", [b.node("Tanh", [b.node("Div", [logits, b.const(np.float32(ts))])]), b.const(np.float32(ts))])
            return logits, "float", n
        # the adaptive head outputs [means, log_std]: the deterministic action is the means
        return b.slice(logits, [0], [n // 2], [1]), "float", n // 2

    if isinstance(space, TupleSpec):
        # TupleDistribution.argmax: per-subspace argmax or means, concatenated; mixed tuples
        # give float32, all-discrete int32 (envs/spaces.py action_dtype)
        if mask is not None:
            raise NotImplementedError("ONNX export: action masks on tuple spaces not mapped")
        mixed = any(not isinstance(s_i, Discrete) for s_i in space.spaces)
        out_elem = ox.TensorProto.FLOAT if mixed else ox.TensorProto.INT32
        parts, offset = [], 0
        for s_i in space.spaces:
            w_i = num_action_parameters(s_i)
            chunk = b.slice(logits, [offset], [offset + w_i], [1])
            offset += w_i
            if isinstance(s_i, Discrete):
                parts.append(b.node("Cast", [b.node("ArgMax", [chunk], axis=-1, keepdims=1)], to=int(out_elem)))
            else:
                means = b.slice(chunk, [0], [w_i // 2], [1])  # adaptive layout [means, log_std]
                parts.append(b.node("Cast", [means], to=int(out_elem)) if out_elem != ox.TensorProto.FLOAT else means)
        width = sum(num_actions(s_i) for s_i in space.spaces)
        return b.node("Concat", parts, axis=1), ("float" if mixed else "int"), width

    if mask is not None:
        # argmax of masked probs == argmax of (logits - (1-mask)*1e9)
        penalty = b.node("Mul", [b.node("Sub", [b.const(np.float32(1.0)), mask]), b.const(np.float32(1e9))])
        logits = b.node("Sub", [logits, penalty])
    am = b.node("ArgMax", [logits], axis=-1, keepdims=1)
    return b.node("Cast", [am], to=int(ox.TensorProto.INT32)), "int", 1


def _refuse_custom_models() -> None:
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    custom = [name for name in ("encoder_factory", "core_factory", "decoder_factory", "actor_critic_factory") if getattr(factory, name)]
    if custom:
        raise NotImplementedError(f"ONNX export: custom models are not mapped ({', '.join(custom)} registered)")


def build_policy_onnx(cfg, env_info, train_state, batch_size: int = 1) -> bytes:
    """Assemble the deterministic-policy ONNX graph from a train state of the port."""
    _refuse_custom_models()
    from sample_factory_tpu_torch import bridge
    from sample_factory_tpu_torch.models.actor_critic import actor_critic_rnn_state_size
    from sample_factory_tpu_torch.onnx.builder import FLOAT, INT32, OnnxGraphBuilder

    model = train_state.model
    params = bridge.state_dict_to_flax(model.state_dict(), model)["params"]
    obs_rms = train_state.obs_rms
    obs_spec = obs_space_as_dict(env_info.obs_space)

    b = OnnxGraphBuilder("sample_factory_tpu_policy")
    raw: Dict[str, str] = {key: b.add_input(key, (batch_size,) + tuple(obs_spec[key].shape), FLOAT) for key in sorted(obs_spec.keys())}
    mask = raw.get("action_mask")
    S = actor_critic_rnn_state_size(cfg)
    rnn_in = b.add_input("rnn_state", (batch_size, S), FLOAT)

    normalized: Dict[str, str] = {}
    for key in sorted(obs_spec.keys()):
        if key == "action_mask":
            continue
        x = _build_preprocess(b, cfg, key, raw[key])
        if obs_rms is not None and key in obs_rms:
            x = _build_normalize(b, obs_rms[key], x)
        normalized[key] = x

    if cfg.actor_critic_share_weights:
        head = _build_encoder(b, cfg, params["encoder"], obs_spec, normalized)
        core_out, new_chunks = _build_core(b, cfg, params.get("core"), head, rnn_in, 0)
        decoded = _dense_stack(b, cfg, params.get("decoder", {}), core_out)
    else:
        actor_head = _build_encoder(b, cfg, params["actor_encoder"], obs_spec, normalized)
        critic_head = _build_encoder(b, cfg, params["critic_encoder"], obs_spec, normalized)
        actor_out, actor_chunks = _build_core(b, cfg, params.get("actor_core"), actor_head, rnn_in, 0)
        _critic_out, critic_chunks = _build_core(b, cfg, params.get("critic_core"), critic_head, rnn_in, S // 2)
        decoded = _dense_stack(b, cfg, params.get("actor_decoder", {}), actor_out)
        new_chunks = actor_chunks + critic_chunks
    actions, kind, width = _build_action_head(b, cfg, env_info, params["action_parameterization"], decoded, mask)

    if cfg.use_rnn:
        new_rnn = b.node("Concat", new_chunks, axis=1) if len(new_chunks) > 1 else new_chunks[0]
    else:
        new_rnn = b.node("Identity", [rnn_in])
    b.add_output(actions, (batch_size, width), INT32 if kind == "int" else FLOAT)
    b.add_output(new_rnn, (batch_size, S), FLOAT)
    return b.model_bytes(
        doc=f"sample_factory_tpu_torch deterministic policy (env={cfg.env}); (obs..., rnn_state) -> (actions, new_rnn_state)"
    )


def export_policy_onnx(cfg, batch_size: int = 1, output_path: Optional[str] = None, register_fn=None) -> str:
    """Load the checkpoint and write <experiment>/policy_p<i>.onnx: the deterministic policy,
    whatever `--eval_deterministic` says (no sampling is mapped)."""
    from sample_factory_tpu_torch.export_model import load_policy

    cfg, env_info, train_state = load_policy(cfg, register_fn)
    blob = build_policy_onnx(cfg, env_info, train_state, batch_size)
    output_path = output_path or join(experiment_dir(cfg), f"policy_p{cfg.policy_index}.onnx")
    with open(output_path, "wb") as f:
        f.write(blob)
    log.info("Exported ONNX policy (%d bytes) to %s", len(blob), output_path)
    return output_path


def main() -> int:
    """python -m sample_factory_tpu_torch.export_onnx --env=... --experiment=... [--export_batch_size=N]
    [--export_output=path]"""
    import argparse

    from sample_factory_tpu_torch.enjoy import register_env_by_name
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--export_batch_size", type=int, default=1)
    extra.add_argument("--export_output", type=str, default=None)
    known, rest = extra.parse_known_args()
    cfg = parse_custom_args(rest, evaluation=True)
    register_fn = register_env_by_name(cfg.env)
    print(export_policy_onnx(cfg, known.export_batch_size, known.export_output, register_fn=register_fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
