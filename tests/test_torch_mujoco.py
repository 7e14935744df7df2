"""The MuJoCo examples (`examples/mujoco/`) against the JAX package's (`sf_examples_tpu/mujoco/`):
the 11 tasks and the tuned defaults value for value, one learner update under `mujoco_params`
(tanh MLP 64-64, Box actions with a non-adaptive stddev, `kl_loss_coeff=0.1`, `value_bootstrap`
over truncations, normalized inputs and returns), JAX against the port from one parameter set
to 1e-5; then a real `mujoco_pendulum` run through worker processes, followed by
`fast_eval_mujoco` and `enjoy_mujoco` on its checkpoint.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")

from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.envs.spaces import Box as JBox, make_dict_spec as jax_dict_spec  # noqa: E402
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic  # noqa: E402
from sf_examples_tpu.mujoco import mujoco_params as jax_mujoco_params  # noqa: E402
from sf_examples_tpu.mujoco import mujoco_utils as jax_mujoco_utils  # noqa: E402
from sf_examples_tpu.mujoco.train_mujoco import parse_mujoco_cfg as jax_parse_mujoco_cfg  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec  # noqa: E402
from sample_factory_tpu_torch.examples.mujoco import mujoco_params, mujoco_utils  # noqa: E402
from sample_factory_tpu_torch.examples.mujoco.train_mujoco import parse_mujoco_cfg  # noqa: E402
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402

torch.set_num_threads(1)


class _RecordingParser:
    def __init__(self):
        self.defaults = {}

    def set_defaults(self, **kwargs):
        self.defaults.update(kwargs)


def test_tasks_and_defaults_match_jax():
    assert mujoco_utils.MUJOCO_ENVS == jax_mujoco_utils.MUJOCO_ENVS and len(mujoco_utils.MUJOCO_ENVS) == 11
    assert mujoco_utils.mujoco_available()
    port, ref = _RecordingParser(), _RecordingParser()
    mujoco_params.mujoco_override_defaults("mujoco_hopper", port)
    jax_mujoco_params.mujoco_override_defaults("mujoco_hopper", ref)
    assert port.defaults == ref.defaults and len(port.defaults) == 35
    tcfg = parse_mujoco_cfg(["--env=mujoco_hopper", "--device=cpu"])
    jcfg = jax_parse_mujoco_cfg(["--env=mujoco_hopper", "--device=cpu"])
    for key in port.defaults:
        assert tcfg[key] == jcfg[key] == port.defaults[key], key
    # a flag typed on the command line wins over the tuned default, on both sides
    assert parse_mujoco_cfg(["--env=mujoco_hopper", "--rollout=8"]).rollout == jax_parse_mujoco_cfg(["--env=mujoco_hopper", "--rollout=8"]).rollout == 8


T, N, OBS, ACT = 16, 4, 11, 3


def test_one_update_under_mujoco_params_matches_jax():
    """One train call of each package from one parameter set: the trajectory ends episodes by
    truncation (value bootstrap) and by termination; 2 minibatches, 2 epochs. Parameters (the
    learned log-stddev included), normalizers and the learning rate after it: 1e-5."""
    argv = ["--env=mujoco_hopper", "--device=cpu", f"--rollout={T}", "--batch_size=32", f"--num_envs={N}", "--seed=0",
            "--train_for_env_steps=8192"]
    jcfg, tcfg = jax_parse_mujoco_cfg(argv), parse_mujoco_cfg(argv)
    assert tcfg.nonlinearity == "tanh" and tcfg.kl_loss_coeff == 0.1 and tcfg.value_bootstrap and not tcfg.adaptive_stddev
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox((OBS,))}), action_space=JBox((ACT,), -1.0, 1.0), num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=make_dict_spec({"obs": Box((OBS,))}), action_space=Box((ACT,), -1.0, 1.0), num_agents=1, is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2, OBS))})
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")

    rng = np.random.default_rng(0)
    ends = rng.random((T, N)) < 0.12
    time_outs = ends & (rng.random((T, N)) < 0.5)
    mean = rng.normal(size=(T, N, ACT)).astype(np.float32) * 0.3
    log_std = np.full((T, N, ACT), -0.2, np.float32)
    actions = (mean + np.exp(log_std) * rng.normal(size=(T, N, ACT))).astype(np.float32)
    log_prob = (-0.5 * ((actions - mean) / np.exp(log_std)) ** 2 - log_std - 0.5 * np.log(2 * np.pi)).sum(-1)
    traj = {
        "obs": {"obs": (rng.normal(size=(T + 1, N, OBS)) * 2.0).astype(np.float32)},
        "rnn_states": np.zeros((T + 1, N, 1), np.float32),
        "actions": actions,
        "action_logits": np.concatenate([mean, log_std], -1),
        "log_prob_actions": log_prob.astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(1.0, 0.5, size=(T, N)).astype(np.float32),
        "dones": ends.astype(np.float32),
        "time_outs": time_outs.astype(np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    assert time_outs.sum() > 0 and (ends & ~time_outs).sum() > 0
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 2 * float(tstats["epochs_executed"])
    assert float(tstats["epochs_executed"]) == float(jstats["epochs_executed"])
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr)) and tts.curr_lr < tcfg.learning_rate
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    assert any("learned_stddev" in name for name in want)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    jrms, trms = jts2.obs_rms["obs"], tts.obs_rms["obs"]
    np.testing.assert_allclose(trms.running_mean.numpy(), np.asarray(jrms.running_mean), atol=1e-6)
    np.testing.assert_allclose(trms.running_var.numpy(), np.asarray(jrms.running_var), atol=1e-6)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)
    assert float(tstats["kl_loss"]) > 0.0


def test_pendulum_trains_then_fast_eval_and_enjoy(tmp_path, monkeypatch):
    """InvertedPendulum-v4 on the real engine at the tuned defaults, cut to 2 workers x 32 envs and
    65,536 steps: random play scores about 8 an episode, the JAX run 144.5 at this step
    (docs/evidence/mujoco_light_envs/summaries_pendulum_seed0.jsonl). Then the example's
    `fast_eval_mujoco` and `enjoy_mujoco` entry points on the checkpoint."""
    from sample_factory_tpu_torch.examples.mujoco import enjoy_mujoco, fast_eval_mujoco
    from sample_factory_tpu_torch.train import make_rl_runner

    reset_global_context()
    mujoco_utils.register_mujoco_components()
    base = ["--env=mujoco_pendulum", "--experiment=pendulum", f"--train_dir={tmp_path}", "--device=cpu", "--seed=0"]
    cfg, runner = make_rl_runner(parse_mujoco_cfg(base + ["--num_workers=2", "--num_envs_per_worker=32", "--train_for_env_steps=65536"]),
                                 register_fn=mujoco_utils.register_mujoco_components)
    runner.init()
    assert runner.sampler.transport == "shm_queue" and not cfg.async_rl
    assert runner.run() == 0 and runner.env_steps == 65536
    avg = runner.episode_stats.avg_reward
    assert avg >= 40.0, avg
    assert glob.glob(os.path.join(str(tmp_path), "pendulum", "checkpoint_p0", "checkpoint_*.pth"))
    reset_global_context()

    monkeypatch.setattr(sys, "argv", ["fast_eval_mujoco"] + base + ["--sample_env_episodes=8", "--num_workers=1", "--num_envs_per_worker=8"])
    assert fast_eval_mujoco.main() == 0
    with open(os.path.join(str(tmp_path), "pendulum", "eval", "eval_p0.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 9 and np.mean([float(r.split(",")[1]) for r in rows[1:]]) >= 40.0
    reset_global_context()
    monkeypatch.setattr(sys, "argv", ["enjoy_mujoco"] + base + ["--no_render", "--max_num_episodes=2"])
    assert enjoy_mujoco.main() == 0
