"""The PettingZoo example (`examples/train_pettingzoo_env.py`) and the adapter through the port's
multi-agent host pipeline, mirroring tests/test_pettingzoo.py; then the example's encoder.

The JAX example's `CustomConvEncoder` pads its three 2x2 convs VALID, so tic-tac-toe's 3x3 board
shrinks to 0x0 and its Dense sees nothing: the policy is blind to the board (the test below shows
it). The port's encoder pads as XLA's SAME does (0 before, 1 after), keeps the 3x3 map, and equals
a flax twin of the JAX class with `padding="SAME"` to 1e-5 through the bridge.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("pettingzoo")

from flax import linen as nn  # noqa: E402

from sample_factory_tpu.algo.context import global_model_factory as jax_global_model_factory  # noqa: E402
from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context  # noqa: E402
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg  # noqa: E402
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec  # noqa: E402
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic  # noqa: E402
from sample_factory_tpu.models.model_utils import kernel_initializer, nonlinearity  # noqa: E402
from sf_examples_tpu import train_pettingzoo_env as jax_example  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import reset_global_context  # noqa: E402
from sample_factory_tpu_torch.cfg.arguments import default_cfg  # noqa: E402
from sample_factory_tpu_torch.envs.env_utils import register_env  # noqa: E402
from sample_factory_tpu_torch.envs.pettingzoo_adapter import make_pettingzoo_env  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec  # noqa: E402
from sample_factory_tpu_torch.examples import train_pettingzoo_env as example  # noqa: E402
from sample_factory_tpu_torch.examples.custom_encoders import CustomConvEncoder  # noqa: E402
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_contexts():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


def _make_rps(full_env_name, cfg=None, env_config=None, render_mode=None):
    return make_pettingzoo_env("pettingzoo.classic.rps_v2", parallel=False)


def register_rps():
    register_env("pz_rps", _make_rps)


def test_adapter_contract():
    env = _make_rps("pz_rps")
    assert env.num_agents == 2 and env.is_multiagent
    obs, infos = env.reset(seed=1)
    assert len(obs) == 2 and obs[0].shape == (4,)
    obs, rewards, terms, truncs, infos = env.step([0, 1])
    assert rewards[0] == -1.0 and rewards[1] == 1.0  # rock loses to paper
    assert all(i["is_active"] for i in infos)
    env.close()


def test_rps_trains_through_pipeline(tmp_path):
    """Zero-sum RPS, self-play with 2 policies, end to end (the machinery, not a target)."""
    from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args
    from sample_factory_tpu_torch.train import make_rl_runner

    register_rps()
    argv = ["--env=pz_rps", "--experiment=rps", f"--train_dir={tmp_path}", "--seed=1", "--device=cpu", "--num_policies=2",
            "--serial_mode=True", "--async_rl=False", "--num_workers=2", "--num_envs_per_worker=8", "--rollout=16",
            "--batch_size=256", "--train_for_env_steps=30000", "--encoder_mlp_layers", "32", "--use_rnn=False", "--save_every_sec=5"]
    _, runner = make_rl_runner(parse_gym_args(argv), register_fn=register_rps)
    assert type(runner).__name__ == "HostMultiPolicyRunner"
    runner.init()
    assert runner.run() == 0 and runner.env_steps >= 30000
    assert all(es.total_episodes > 0 for es in runner.episode_stats_per_policy)


def test_tictactoe_example_train_enjoy(tmp_path):
    """The turn-based classic example (custom conv encoder registered via the model factory)
    trains through worker processes and round-trips through `enjoy`."""
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.train import make_rl_runner

    example.register_custom_components()
    argv = ["--env=tictactoe_v3", "--experiment=ttt", f"--train_dir={tmp_path}", "--seed=0", "--device=cpu", "--num_workers=2",
            "--num_envs_per_worker=4", "--batch_size=256", "--train_for_env_steps=4000", "--save_every_sec=5"]
    cfg, runner = make_rl_runner(example.parse_custom_args(argv), register_fn=example.register_custom_components)
    runner.init()
    assert runner.sampler.transport == "shm_queue" and isinstance(runner.train_state.model.encoder, CustomConvEncoder)
    assert runner.train_state.model.encoder.conv_out_hwc == (3, 3, 128)
    assert runner.run() == 0

    eval_cfg = example.parse_custom_args(argv + ["--no_render", "--max_num_episodes=3"], evaluation=True)
    episodes = []
    status, _ = enjoy(eval_cfg, collect_episodes=episodes)
    assert status == 0 and len(episodes) == 3


class SamePaddedJaxEncoder(nn.Module):
    """The JAX example's CustomConvEncoder (sf_examples_tpu/train_pettingzoo_env.py:30-54) with
    padding="SAME" in place of "VALID"."""

    cfg: object
    obs_space: object

    @nn.compact
    def __call__(self, obs_dict):
        act = nonlinearity(self.cfg)
        x = obs_dict["obs"]
        batch_dims = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        for out_ch in (32, 64, 128):
            x = nn.Conv(out_ch, (2, 2), padding="SAME", kernel_init=kernel_initializer(self.cfg))(x)
            x = act(x)
        x = x.reshape(batch_dims + (-1,))
        for size in self.cfg.encoder_conv_mlp_layers:
            x = nn.Dense(size, kernel_init=kernel_initializer(self.cfg))(x)
            x = act(x)
        return x


BOARD, MASK = (3, 3, 2), (9,)
ARGV = ["--use_rnn=False", "--encoder_conv_mlp_layers", "128", "--seed=0"]


def _jax_model(encoder_cls):
    jax_global_model_factory().register_encoder_factory(lambda cfg, obs_space: encoder_cls(cfg, obs_space))
    jcfg = jax_default_cfg(env="tictactoe_v3", argv=ARGV)
    model = jax_create_actor_critic(jcfg, jax_dict_spec({"obs": JBox(BOARD, 0.0, 1.0), "action_mask": JBox(MASK, 0.0, 1.0)}), JDiscrete(9))
    obs = {"obs": jnp.zeros((2,) + BOARD), "action_mask": jnp.ones((2,) + MASK)}
    return model, model.init(jax.random.PRNGKey(0), obs, jnp.zeros((2, 1)))


def _boards():
    rng = np.random.default_rng(0)
    boards = rng.integers(0, 2, (6,) + BOARD).astype(np.float32)
    boards[0], boards[1] = 0.0, 1.0
    return {"obs": boards, "action_mask": np.ones((6,) + MASK, np.float32)}


def test_jax_example_encoder_is_blind_to_the_board():
    """Three 2x2 VALID convs leave a 0x0 map: the first Dense has no rows and the head is the same
    for every board."""
    model, params = _jax_model(jax_example.CustomConvEncoder)
    assert params["params"]["encoder"]["Dense_0"]["kernel"].shape == (0, 128)
    head = np.asarray(model.apply(params, {k: jnp.asarray(v) for k, v in _boards().items()}, method="forward_head"))
    assert np.abs(head - head[0]).max() == 0.0


def test_port_encoder_sees_the_board_and_equals_the_same_padded_twin():
    model, params = _jax_model(SamePaddedJaxEncoder)
    assert params["params"]["encoder"]["Dense_0"]["kernel"].shape == (3 * 3 * 128, 128)
    example.register_custom_components()
    tcfg = default_cfg(env="tictactoe_v3", argv=ARGV + ["--device=cpu"])
    tmodel = create_actor_critic(tcfg, make_dict_spec({"obs": Box(BOARD, 0.0, 1.0), "action_mask": Box(MASK, 0.0, 1.0)}), Discrete(9))
    assert isinstance(tmodel.encoder, CustomConvEncoder) and tmodel.encoder.conv_out_hwc == (3, 3, 128)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    obs = _boards()
    jhead = np.asarray(model.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}, method="forward_head"))
    jlogits, jvalues, _ = model.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.zeros((6, 1)))
    with torch.no_grad():
        thead = tmodel.forward_head({k: torch.tensor(v) for k, v in obs.items()}).numpy()
        tlogits, tvalues, _ = tmodel({k: torch.tensor(v) for k, v in obs.items()}, torch.zeros(6, 1))
    np.testing.assert_allclose(thead, jhead, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues), atol=1e-5, rtol=0)
    # the board reaches the head: an empty board and a full one differ, and so do all six
    assert np.abs(thead[0] - thead[1]).max() > 1e-3
    assert min(np.abs(thead[i] - thead[j]).max() for i in range(6) for j in range(i)) > 0.0
