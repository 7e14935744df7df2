"""The port's models against flax `apply`, with parameters carried over by the bridge.

Inputs are made with numpy from a seed and fed to both sides. float32 runs agree
to 1e-5. bfloat16 runs agree to a looser bound: both frameworks round each op to
bf16, but at different places (XLA on the CPU may fuse ops and keep f32
intermediates, torch rounds every op), so single values differ by a few bf16
ulps (2^-8 relative), and the differences pass through the layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu.models.encoder import ConvEncoder as JaxConvEncoder
from sample_factory_tpu.utils.static_cfg import StaticConfig
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.models.encoder import ConvEncoder

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_ATOL = 0.03  # measured up to 0.0078 (one bf16 ulp at magnitude 1-2)


def _cfgs(extra):
    argv = [
        "--encoder_conv_architecture=convnet_impala",
        "--encoder_conv_mlp_layers", "32",
        "--encoder_mlp_layers", "24", "16",
        "--rnn_size=32",
        "--seed=0",
    ] + list(extra)
    return jax_default_cfg(env="test", argv=argv), default_cfg(env="test", argv=argv + ["--device=cpu"])


def _models(extra, obs_shapes, num_actions=6, box_actions=0):
    jcfg, tcfg = _cfgs(extra)
    jspace, tspace = (JBox((box_actions,)), Box((box_actions,))) if box_actions else (JDiscrete(num_actions), Discrete(num_actions))
    jmodel = jax_create_actor_critic(jcfg, jax_dict_spec({k: JBox(s) for k, s in obs_shapes.items()}), jspace)
    tmodel = create_actor_critic(tcfg, make_dict_spec({k: Box(s) for k, s in obs_shapes.items()}), tspace)
    return jcfg, jmodel, tmodel


def _obs(obs_shapes, batch, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=batch + tuple(s)).astype(np.float32) for k, s in obs_shapes.items()}


def _state_width(extra):
    return 64 if "--rnn_type=lstm" in extra else 32


def _init(jmodel, tmodel, obs, rnn):
    params = jmodel.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(rnn))
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    return params


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)


CONFIGS = [
    pytest.param(["--rnn_type=gru"], id="gru"),
    pytest.param(["--rnn_type=lstm"], id="lstm"),
    pytest.param(["--rnn_type=gru", "--decoder_mlp_layers", "16"], id="gru-decoder"),
    pytest.param(["--rnn_type=gru", "--rnn_num_layers=2"], id="gru-2layers"),
    pytest.param(["--use_rnn=False"], id="feedforward"),
]


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("extra", CONFIGS)
def test_actor_critic_step_matches_flax(extra, dtype, atol):
    """36x36 obs: convnet_impala leaves a 3x3x32 map, so the NHWC->NCHW flatten order matters."""
    extra = extra + [f"--compute_dtype={dtype}"]
    obs_shapes = {"obs": (36, 36, 3)}
    _, jmodel, tmodel = _models(extra, obs_shapes)
    obs = _obs(obs_shapes, (5,))
    width = 1 if "--use_rnn=False" in extra else _state_width(extra) * (2 if "--rnn_num_layers=2" in extra else 1)
    rnn = np.random.default_rng(1).normal(size=(5, width)).astype(np.float32)
    params = _init(jmodel, tmodel, obs, rnn)
    a, v, s = jmodel.apply(params, {k: jnp.asarray(x) for k, x in obs.items()}, jnp.asarray(rnn))
    with torch.no_grad():
        ta, tv, ts = tmodel({k: torch.tensor(x) for k, x in obs.items()}, torch.tensor(rnn))
    assert ta.dtype == tv.dtype == ts.dtype == torch.float32
    _close(ta, a, atol)
    _close(tv, v, atol)
    _close(ts, s, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_core_seq_matches_flax(rnn_type, dtype, atol):
    """Sequence mode (the BPTT path) with mid-sequence resets. JAX runs its default
    lax.scan cell here; the port runs the kernel's plain version."""
    extra = [f"--rnn_type={rnn_type}", f"--compute_dtype={dtype}"]
    obs_shapes = {"obs": (36, 36, 3)}
    _, jmodel, tmodel = _models(extra, obs_shapes)
    obs = _obs(obs_shapes, (4,))
    rng = np.random.default_rng(2)
    rnn = rng.normal(size=(4, _state_width(extra))).astype(np.float32)
    params = _init(jmodel, tmodel, obs, rnn)
    T = 6
    head = rng.normal(size=(T, 4, 32)).astype(np.float32)
    resets = (rng.random((T, 4)) < 0.3).astype(np.float32)
    o, f = jmodel.apply(params, jnp.asarray(head), jnp.asarray(rnn), jnp.asarray(resets), method="forward_core_seq")
    with torch.no_grad():
        to, tf = tmodel.forward_core_seq(torch.tensor(head), torch.tensor(rnn), torch.tensor(resets))
    _close(to, o, atol)
    _close(tf, f, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_multi_input_encoder_matches_flax(dtype, atol):
    """Sorted keys, an MLP encoder for the vector key, and `action_mask` skipped."""
    obs_shapes = {"obs": (36, 36, 3), "measurements": (7,), "action_mask": (6,)}
    _, jmodel, tmodel = _models([f"--compute_dtype={dtype}"], obs_shapes)
    obs = _obs(obs_shapes, (3, 2))  # two batch dims, as the learner's [S, R, ...]
    params = _init(jmodel, tmodel, {k: v[0] for k, v in obs.items()}, np.zeros((2, 32), np.float32))
    h = jmodel.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}, method="forward_head")
    with torch.no_grad():
        th = tmodel.forward_head({k: torch.tensor(v) for k, v in obs.items()})
    assert th.shape == (3, 2, 32 + 16)
    _close(th, h, atol)


def test_bridge_round_trip():
    obs_shapes = {"obs": (36, 36, 3), "measurements": (7,)}
    extra = ["--rnn_type=lstm", "--decoder_mlp_layers", "16"]
    _, jmodel, tmodel = _models(extra, obs_shapes)
    obs = _obs(obs_shapes, (2,))
    params = jax.tree.map(np.asarray, _init(jmodel, tmodel, obs, np.zeros((2, 64), np.float32)))
    back = bridge.state_dict_to_flax(tmodel.state_dict(), tmodel)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back) == len(tmodel.state_dict())
    for path, value in flat:
        np.testing.assert_array_equal(flat_back[path], value)


def test_bridge_permutes_rows_after_conv():
    """The first dense weight after the convs is the JAX kernel with NHWC rows put in NCHW order."""
    obs_shapes = {"obs": (36, 36, 3)}
    _, jmodel, tmodel = _models([], obs_shapes)
    obs = _obs(obs_shapes, (2,))
    params = jax.tree.map(np.asarray, _init(jmodel, tmodel, obs, np.zeros((2, 32), np.float32)))
    kernel = params["params"]["encoder"]["enc_obs"]["Dense_0"]["kernel"]  # [3*3*32, 32], NHWC rows
    weight = tmodel.encoder.encoders["enc_obs"].dense[0].weight.detach().numpy()
    h, w, c = tmodel.encoder.encoders["enc_obs"].conv_out_hwc
    assert (h, w, c) == (3, 3, 32)
    for ch, i, j in [(0, 0, 0), (5, 1, 2), (31, 2, 1)]:
        np.testing.assert_array_equal(weight[:, ch * h * w + i * w + j], kernel[(i * w + j) * c + ch])


def test_conv_encoder_refuses_an_empty_feature_map():
    """grid_battle_small (12x12) under convnet_impala leaves a 0x0 map: flax computes an
    (N, 0, 0, 32) map and the Dense after it sees no pixels; the port refuses."""
    jcfg, tcfg = _cfgs([])
    x = jnp.zeros((2, 12, 12, 3))
    out, _ = JaxConvEncoder(StaticConfig(jcfg)).init_with_output(jax.random.PRNGKey(0), x)
    assert out.shape == (2, 32)
    with pytest.raises(ValueError, match="convnet_impala on a 12x12 observation leaves a 0x0"):
        ConvEncoder(tcfg, (12, 12, 3))
    assert ConvEncoder(tcfg, (24, 24, 3)).conv_out_hwc == (1, 1, 32)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("size", [24, 21], ids=["even-24", "odd-21"])
def test_resnet_encoder_matches_flax(size, dtype, atol):
    """resnet_impala on an even and an odd image: XLA's SAME max-pool pads an even size
    only after (24 -> 12 -> 6 -> 3) and an odd size on both sides (21 -> 11 -> 6 -> 3)."""
    obs_shapes = {"obs": (size, size, 3)}
    extra = ["--encoder_conv_architecture=resnet_impala", "--use_rnn=False", f"--compute_dtype={dtype}"]
    _, jmodel, tmodel = _models(extra, obs_shapes)
    obs = _obs(obs_shapes, (3, 2))
    params = _init(jmodel, tmodel, {k: v[0] for k, v in obs.items()}, np.zeros((2, 1), np.float32))
    assert tmodel.encoder.encoders["enc_obs"].conv_out_hwc == (3, 3, 32)
    h = jmodel.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}, method="forward_head")
    with torch.no_grad():
        th = tmodel.forward_head({k: torch.tensor(v) for k, v in obs.items()})
    assert th.shape == (3, 2, 32)
    _close(th, h, atol)


def test_max_pool_same_pads_as_xla():
    from flax import linen as nn

    from sample_factory_tpu_torch.models.encoder import max_pool_same

    rng = np.random.default_rng(0)
    for h, w in [(6, 6), (7, 7), (6, 9), (1, 2)]:
        x = -np.abs(rng.normal(size=(2, h, w, 3))).astype(np.float32)  # all negative: zero padding would win
        want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
        got = max_pool_same(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SEPARATE = [
    pytest.param(["--rnn_type=gru"], 32, id="gru"),
    pytest.param(["--rnn_type=lstm", "--rnn_num_layers=2"], 128, id="lstm-2layers"),
]


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("extra,tower_state", SEPARATE)
def test_separate_weights_model_matches_flax(extra, tower_state, dtype, atol):
    """Two towers: the head output is [actor || critic] and so is the flat RNN state.
    Step mode, then sequence mode with resets (JAX: its lax.scan cell; the port: the
    kernels' plain versions)."""
    extra = extra + ["--actor_critic_share_weights=False", f"--compute_dtype={dtype}"]
    obs_shapes = {"obs": (36, 36, 3)}
    _, jmodel, tmodel = _models(extra, obs_shapes)
    obs = _obs(obs_shapes, (4,))
    rng = np.random.default_rng(5)
    rnn = rng.normal(size=(4, 2 * tower_state)).astype(np.float32)
    params = _init(jmodel, tmodel, obs, rnn)
    a, v, s = jmodel.apply(params, {k: jnp.asarray(x) for k, x in obs.items()}, jnp.asarray(rnn))
    with torch.no_grad():
        ta, tv, ts = tmodel({k: torch.tensor(x) for k, x in obs.items()}, torch.tensor(rnn))
    assert ts.shape == (4, 2 * tower_state)
    for port, ref in ((ta, a), (tv, v), (ts, s)):
        _close(port, ref, atol)

    T = 6
    head = rng.normal(size=(T, 4, 64)).astype(np.float32)
    resets = (rng.random((T, 4)) < 0.3).astype(np.float32)
    o, f = jmodel.apply(params, jnp.asarray(head), jnp.asarray(rnn), jnp.asarray(resets), method="forward_core_seq")
    with torch.no_grad():
        to, tf = tmodel.forward_core_seq(torch.tensor(head), torch.tensor(rnn), torch.tensor(resets))
        ta, tv = tmodel.forward_tail(to)
    a, v = jmodel.apply(params, o, method="forward_tail")
    assert to.shape == (T, 4, 64)
    for port, ref in ((to, o), (tf, f), (ta, a), (tv, v)):
        _close(port, ref, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("tanh_scale", [0.0, 1.5])
def test_non_adaptive_stddev_head_matches_flax(tanh_scale, dtype, atol):
    extra = ["--use_rnn=False", "--adaptive_stddev=False", "--initial_stddev=0.7",
             f"--continuous_tanh_scale={tanh_scale}", f"--compute_dtype={dtype}"]
    obs_shapes = {"obs": (7,)}
    _, jmodel, tmodel = _models(extra, obs_shapes, box_actions=3)
    obs = _obs(obs_shapes, (5,))
    rnn = np.zeros((5, 1), np.float32)
    params = _init(jmodel, tmodel, obs, rnn)
    stddev = tmodel.action_parameterization.learned_stddev
    assert stddev.requires_grad and stddev.shape == (3,)
    np.testing.assert_allclose(stddev.detach().numpy(), np.log(0.7), rtol=1e-6)
    # a fresh port model starts from log(initial_stddev) too
    fresh = create_actor_critic(_cfgs(extra)[1], make_dict_spec({"obs": Box((7,))}), Box((3,)), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(fresh.action_parameterization.learned_stddev.detach().numpy(), np.log(0.7), rtol=1e-6)
    a, v, _ = jmodel.apply(params, {k: jnp.asarray(x) for k, x in obs.items()}, jnp.asarray(rnn))
    with torch.no_grad():
        ta, tv, _ = tmodel({k: torch.tensor(x) for k, x in obs.items()}, torch.tensor(rnn))
    assert ta.shape == (5, 6)
    _close(ta, a, atol)
    _close(tv, v, atol)


BRIDGED = [
    pytest.param(["--encoder_conv_architecture=resnet_impala", "--actor_critic_share_weights=False", "--rnn_type=lstm",
                  "--rnn_num_layers=2"], 0, 256, id="resnet-towers-lstm2"),
    pytest.param(["--use_rnn=False", "--adaptive_stddev=False"], 3, 1, id="learned-stddev"),
]


@pytest.mark.parametrize("extra,box_actions,state", BRIDGED)
def test_bridge_round_trip_new_trees(extra, box_actions, state):
    """flax -> torch -> flax is exact for the two towers, the ResBlock convs and learned_stddev."""
    obs_shapes = {"obs": (24, 24, 3), "measurements": (7,)}
    _, jmodel, tmodel = _models(extra, obs_shapes, box_actions=box_actions)
    obs = _obs(obs_shapes, (2,))
    params = jax.tree.map(np.asarray, _init(jmodel, tmodel, obs, np.zeros((2, state), np.float32)))
    back = bridge.state_dict_to_flax(tmodel.state_dict(), tmodel)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back) == len(tmodel.state_dict())
    for path, value in flat:
        np.testing.assert_array_equal(flat_back[path], value)
