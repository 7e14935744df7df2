"""The custom-model example (`examples/train_custom_env_custom_model.py`) against the JAX
package's (`sf_examples_tpu/train_custom_env_custom_model.py`): the pixel env value for value,
the user-registered encoder through the bridge (float32, 1e-5; it pads as XLA's SAME does,
42 -> 11 -> 6 -> 3), the model factory, a training run through a worker process with `enjoy`
after it, and a JAX checkpoint of the example restored in the port (logits to 1e-5).
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.algo.running_mean_std import obs_rms_normalize as jax_obs_rms_normalize
from sample_factory_tpu.algo.sampling import _static_preprocess as jax_static_preprocess
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.env_info import obtain_env_info as jax_obtain_env_info
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu.runner.checkpoint import load_checkpoint as jax_load_checkpoint
from sample_factory_tpu.train import run_rl as jax_run_rl
from sf_examples_tpu import train_custom_env_custom_model as jax_example
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.context import global_model_factory, reset_global_context
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import normalize_obs
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.examples import train_custom_env_custom_model as example
from sample_factory_tpu_torch.examples.custom_encoders import CustomPixelEncoder
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.models.model_utils import Conv, same_padding
from sample_factory_tpu_torch.runner.checkpoint import restore_from_jax_checkpoint

torch.set_num_threads(1)

OBS = (example.RES, example.RES, example.STACK)


@pytest.fixture(autouse=True)
def _fresh_contexts():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


def test_pixel_env_matches_jax():
    """One seed, one action sequence: identical observations, rewards, terminations and
    truncations over two episodes, and the spaces in the port's own specs."""
    assert (example.RES, example.STACK, example.EPISODE_LEN) == (jax_example.RES, jax_example.STACK, jax_example.EPISODE_LEN)
    jenv, tenv = jax_example.CustomPixelEnv(num_envs=5, seed=3), example.CustomPixelEnv(num_envs=5, seed=3)
    assert tenv.observation_space == Box(OBS, 0.0, 255.0, "uint8") and tenv.action_space == Discrete(4)
    (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
    np.testing.assert_array_equal(tobs, jobs)
    actions = np.random.default_rng(0).integers(0, 4, (2 * example.EPISODE_LEN, 5))
    truncations = 0
    for a in actions:
        jout, tout = jenv.step(a), tenv.step(a)
        for j, t in zip(jout[:4], tout[:4]):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        truncations += int(tout[3].sum())
    assert truncations == 2 * 5
    (jobs, _), (tobs, _) = jenv.reset(seed=9), tenv.reset(seed=9)
    np.testing.assert_array_equal(tobs, jobs)
    # the factory's seeding: seed, env_seed_offset and the worker-split id
    cfg = type("C", (), {"seed": 4, "env_seed_offset": 7})()
    split = type("E", (), {"num_envs": 3, "env_id": 2})()
    np.testing.assert_array_equal(example.make_custom_pixel_env("e", cfg, split).reset()[0],
                                  jax_example.make_custom_pixel_env("e", cfg, split).reset()[0])


@pytest.mark.parametrize("size,kernel,stride,want", [(42, 8, 4, (3, 3)), (11, 4, 2, (1, 2)), (6, 3, 2, (0, 1)), (3, 2, 1, (0, 1)), (8, 3, 1, (1, 1))])
def test_same_padding_is_xlas(size, kernel, stride, want):
    """The padding XLA's SAME puts before and after; `Conv(padding="same")` against flax's SAME conv."""
    assert same_padding(size, kernel, stride) == want
    from flax import linen as nn

    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    conv = nn.Conv(4, (kernel, kernel), strides=(stride, stride))
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_out = np.asarray(conv.apply(params, jnp.asarray(x)))
    tconv = Conv(3, 4, kernel, stride, padding="same")
    tconv.weight.data = torch.tensor(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1))
    tconv.bias.data = torch.tensor(np.asarray(params["params"]["bias"]))
    out = tconv(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want_out, atol=1e-5, rtol=0)


def _models(extra=()):
    argv = ["--use_rnn=False", "--seed=0"] + list(extra)
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    jax_example.register_custom_components()
    example.register_custom_components()
    jmodel = jax_create_actor_critic(jcfg, jax_dict_spec({"obs": JBox(OBS, 0.0, 255.0, "uint8")}), JDiscrete(4))
    tmodel = create_actor_critic(tcfg, make_dict_spec({"obs": Box(OBS, 0.0, 255.0, "uint8")}), Discrete(4))
    return jmodel, tmodel


def test_custom_encoder_matches_jax_through_the_bridge():
    """The registered encoder inside the actor-critic: flax parameters carried in strictly (the
    rows of the Dense after the convs permuted), then the head, logits and values to 1e-5, and
    the parameters carried back out unchanged."""
    jmodel, tmodel = _models()
    assert isinstance(tmodel.encoder, CustomPixelEncoder) and tmodel.encoder.conv_out_hwc == (3, 3, 32)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(5,) + OBS).astype(np.float32)
    rnn = np.zeros((5, 1), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), {"obs": jnp.asarray(obs)}, jnp.asarray(rnn))
    assert params["params"]["encoder"]["Dense_0"]["kernel"].shape == (288, 128)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    jhead = jmodel.apply(params, {"obs": jnp.asarray(obs)}, method="forward_head")
    jlogits, jvalues, _ = jmodel.apply(params, {"obs": jnp.asarray(obs)}, jnp.asarray(rnn))
    with torch.no_grad():
        thead = tmodel.forward_head({"obs": torch.tensor(obs)})
        tlogits, tvalues, _ = tmodel({"obs": torch.tensor(obs)}, torch.tensor(rnn))
        # more batch dims, as the learner's [S, R, ...]
        thead2 = tmodel.forward_head({"obs": torch.tensor(obs[:4].reshape((2, 2) + OBS))})
    assert thead.shape == (5, 128)
    np.testing.assert_allclose(thead.numpy(), np.asarray(jhead), atol=1e-5, rtol=0)
    np.testing.assert_allclose(thead2.reshape(4, 128).numpy(), np.asarray(jhead)[:4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues), atol=1e-5, rtol=0)
    back = dict(jax.tree_util.tree_leaves_with_path(bridge.state_dict_to_flax(tmodel.state_dict(), tmodel)))
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, params))
    assert len(flat) == len(back) == len(tmodel.state_dict())
    for path, value in flat:
        np.testing.assert_array_equal(back[path], value)


def test_model_factory_encoder_ends_up_in_the_model():
    """Mirror of tests/test_model.py::test_custom_model_factory: a tiny registered encoder is the
    model's head; the example's factory builds its encoder from the observation space."""
    from sample_factory_tpu_torch.models.model_utils import Dense

    class TinyEncoder(torch.nn.Module):
        def __init__(self, cfg, obs_space):
            super().__init__()
            self.dense = Dense(obs_space["obs"].shape[0], 12)

        def get_out_size(self):
            return 12

        def forward(self, obs_dict):
            return self.dense(obs_dict["obs"])

    global_model_factory().register_encoder_factory(lambda cfg, obs_space: TinyEncoder(cfg, obs_space))
    cfg = default_cfg(env="e", argv=["--use_rnn=False", "--device=cpu"])
    model = create_actor_critic(cfg, make_dict_spec({"obs": Box((8,))}), Discrete(6))
    assert isinstance(model.encoder, TinyEncoder)
    obs = {"obs": torch.randn(3, 8)}
    assert model.forward_head(obs).shape == (3, 12)
    logits, values, _ = model(obs, torch.zeros(3, 1))
    assert logits.shape == (3, 6) and values.shape == (3,)

    reset_global_context()
    example.register_custom_components()
    assert global_model_factory().encoder_factory is example.make_custom_pixel_encoder
    model = create_actor_critic(cfg, make_dict_spec({"obs": Box((20, 30, 2), 0.0, 255.0, "uint8")}), Discrete(4))
    assert isinstance(model.encoder, CustomPixelEncoder) and model.encoder.conv_out_hwc == (2, 2, 32)
    assert model.forward_head({"obs": torch.zeros(2, 20, 30, 2)}).shape == (2, 128)


def _argv(tmp_path, experiment, steps=2048):
    return ["--env=my_custom_pixel_env", f"--experiment={experiment}", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=1",
            "--num_envs_per_worker=16", "--rollout=16", "--batch_size=256", f"--train_for_env_steps={steps}", "--seed=0"]


def test_example_trains_through_a_worker_process_then_enjoy(tmp_path):
    """The example's own defaults (async, the quantized learner, normalize_input) with the env in
    a worker process over the shared-memory queue; then `enjoy` on its checkpoint."""
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.train import make_rl_runner

    example.register_custom_components()
    cfg, runner = make_rl_runner(example.parse_custom_args(_argv(tmp_path, "pixel")), register_fn=example.register_custom_components)
    assert cfg.async_rl and cfg.normalize_input and not cfg.serial_mode
    runner.init()
    assert type(runner).__name__ == "HostEnvRunner" and runner.sampler.transport == "shm_queue"
    assert isinstance(runner.train_state.model.encoder, CustomPixelEncoder)
    assert runner.run() == 0 and runner.env_steps == 2048
    assert glob.glob(os.path.join(str(tmp_path), "pixel", "checkpoint_p0", "checkpoint_*.pth"))

    episodes = []
    status, avg = enjoy(example.parse_custom_args(_argv(tmp_path, "pixel") + ["--no_render", "--max_num_episodes=2"], evaluation=True),
                        collect_episodes=episodes)
    assert status == 0 and len(episodes) == 2 and all(n == example.EPISODE_LEN for _, n in episodes)
    assert 0.0 <= avg <= example.EPISODE_LEN


def test_jax_checkpoint_of_the_example_restores_in_the_port(tmp_path):
    """The JAX example trains (serial mode) and writes a `.msgpack`; the port restores it into a
    model with its own custom encoder and gives the same logits and values on the same uint8
    frames, the observation normalizer included: float32, 1e-5."""
    common = _argv(tmp_path, "jax_pixel") + ["--serial_mode=True"]
    jax_example.register_custom_components()
    jcfg = jax_example.parse_custom_args(common)
    assert jax_run_rl(jcfg, register_fn=jax_example.register_custom_components) == 0
    (path,) = glob.glob(os.path.join(str(tmp_path), "jax_pixel", "checkpoint_p0", "checkpoint_*.msgpack"))

    frames = np.random.default_rng(0).integers(0, 256, (6,) + OBS).astype(np.uint8)
    jinfo = jax_obtain_env_info(jcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    template = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(0), {"obs": jnp.asarray(frames[:2])})
    jts, jsteps, _ = jax_load_checkpoint(jcfg, 0, template)
    jnorm = jax_obs_rms_normalize(jts.obs_rms, jax_static_preprocess(jcfg, {"obs": jnp.asarray(frames)}))
    jlogits, jvalues, _ = jmodel.apply(jts.params, jnorm, jnp.zeros((6, 1)))
    jax_reset_global_context()

    example.register_custom_components()
    tcfg = example.parse_custom_args(common)
    tinfo = obtain_env_info(tcfg, register_fn=example.register_custom_components)
    tts = init_train_state(tcfg, tinfo, create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space), "cpu")
    assert isinstance(tts.model.encoder, CustomPixelEncoder)
    assert restore_from_jax_checkpoint(tts, path)[0] == jsteps == 2048
    np.testing.assert_array_equal(tts.obs_rms["obs"].running_mean.numpy(), np.asarray(jts.obs_rms["obs"].running_mean))
    with torch.no_grad():
        tlogits, tvalues, _ = tts.model(normalize_obs(tcfg, tts.obs_rms, {"obs": torch.tensor(frames)}), torch.zeros(6, 1))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues), atol=1e-5, rtol=0)
