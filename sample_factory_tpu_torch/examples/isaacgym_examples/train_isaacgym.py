"""IsaacGym Envs integration (gated on the isaacgym/isaacgymenvs packages).

Counterpart of `sf_examples_tpu/isaacgym_examples/train_isaacgym.py` (reference
`sf_examples/isaacgym_examples/train_isaacgym.py`): env construction through the IGE hydra
configs, the obs/states key selection, and the per-task tuned hyperparameters, value for value.
Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.isaacgym_examples.train_isaacgym --env=Ant --experiment=ant1

Three things differ from the JAX module:
- `isaacgym` is imported first, before anything of the port: its dependency check refuses a
  process that has imported torch, and every module of the port imports torch.
- hydra's `initialize` runs as a context manager. hydra keeps one global configuration and refuses
  a second `initialize` in a process; the JAX module calls it bare, so a second env in one process
  (the sampler's after the env-info probe of `--serial_mode`, or `enjoy` after training) raises.
- The adapter declares its spaces in the port's specs, not gymnasium's.

The data path is the JAX adapter's: the sim's tensors come to host numpy each step as per-agent
lists under the multi-agent convention (`num_agents` = sim envs), and the sim's `time_outs`
becomes `truncated`. The sim keeps its buffers on the card; keeping them there for the learner
would be a feature the JAX package lacks (ROADMAP B).
"""

from __future__ import annotations

try:
    import isaacgym  # noqa: F401  # before torch: see the module's docstring
except ImportError:
    pass

import sys  # noqa: E402
from typing import Optional  # noqa: E402

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args  # noqa: E402
from sample_factory_tpu_torch.utils.utils import log, str2bool  # noqa: E402


def isaacgym_available() -> bool:
    try:
        import isaacgym  # noqa: F401
        import isaacgymenvs  # noqa: F401

        return True
    except ImportError:
        return False


# IGE task names (match IGE config file names); each gets tuned defaults below
ISAACGYM_ENVS = [
    "Ant",
    "Anymal",
    "AnymalTerrain",
    "BallBalance",
    "Cartpole",
    "ShadowHand",
    "Humanoid",
    "AllegroHand",
    "AllegroHandLSTM",
]


class IsaacGymBatchedEnv:
    """Batched vectorized adapter: one IGE sim with N parallel agents exposed
    through the host multi-agent convention (num_agents = sim envs); the sim's
    tensors are converted at the host boundary."""

    is_multiagent = True

    def __init__(self, ige_env, obs_key: str):
        from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec

        self.env = ige_env
        self.num_agents = self.env.num_envs
        self.obs_key = obs_key
        space = self.env.state_space if obs_key == "states" else self.env.observation_space
        self.observation_space = make_dict_spec({"obs": Box(tuple(int(s) for s in space.shape), dtype="float32")})
        self.action_space = Box(tuple(int(s) for s in self.env.action_space.shape), -1.0, 1.0, "float32")

    def _obs_list(self, obs_dict):
        import numpy as np

        obs = obs_dict[self.obs_key if self.obs_key in obs_dict else "obs"]
        obs_np = np.asarray(obs.cpu().numpy(), np.float32)
        return [{"obs": obs_np[i]} for i in range(self.num_agents)]

    def reset(self, *args, **kwargs):
        obs_dict = self.env.reset()
        return self._obs_list(obs_dict), [{} for _ in range(self.num_agents)]

    def step(self, action_list):
        import numpy as np
        import torch

        actions = torch.from_numpy(np.stack(action_list)).to(self.env.device)
        obs, rew, terminated, infos = self.env.step(actions)
        truncated = infos.get("time_outs") if isinstance(infos, dict) else None
        rew_np = rew.cpu().numpy()
        term_np = terminated.cpu().numpy().astype(bool)
        trunc_np = truncated.cpu().numpy().astype(bool) if truncated is not None else np.zeros_like(term_np)
        info_list = [{} for _ in range(self.num_agents)]
        return self._obs_list(obs), list(rew_np), list(term_np), list(trunc_np), info_list

    def render(self):
        pass

    def close(self):
        pass


def make_isaacgym_env(full_env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not isaacgym_available():
        raise RuntimeError(
            "isaacgym/isaacgymenvs are not installed (NVIDIA's simulator, with IsaacGymEnvs' tasks "
            "and hydra configs); install both to train on IsaacGym tasks."
        )
    import os
    from os.path import join

    import isaacgymenvs
    from hydra import compose, initialize
    from isaacgymenvs.tasks import isaacgym_task_map
    from isaacgymenvs.utils.reformat import omegaconf_to_dict

    task_name = full_env_name.split("isaacgym_")[-1] if full_env_name.startswith("isaacgym_") else full_env_name
    overrides = [f"task={task_name}"]
    if cfg.env_agents > 0:
        overrides.append(f"num_envs={cfg.env_agents}")
    if cfg.subtask is not None:
        overrides.append(f"task/env={cfg.subtask}")

    cfg_dir = os.path.relpath(join(isaacgymenvs.__path__[0], "cfg"), os.path.dirname(os.path.abspath(__file__)))
    with initialize(config_path=cfg_dir, job_name="sftpu_isaacgym"):
        ige_cfg = compose(config_name="config", overrides=overrides)
    task_cfg = omegaconf_to_dict(ige_cfg)["task"]

    make_env = isaacgym_task_map[task_cfg["name"]]
    env = make_env(
        cfg=task_cfg,
        sim_device=ige_cfg.sim_device,
        rl_device=ige_cfg.rl_device,
        graphics_device_id=ige_cfg.graphics_device_id,
        headless=render_mode != "human",
        virtual_screen_capture=False,
        force_render=render_mode == "human",
    )
    return IsaacGymBatchedEnv(env, cfg.obs_key)


def register_isaacgym_envs() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for name in ISAACGYM_ENVS:
        register_env(name, make_isaacgym_env)
    if not isaacgym_available():
        log.debug("isaacgym not installed; envs registered but will raise on creation")


def add_isaacgym_env_args(_env, parser):
    p = parser
    p.add_argument("--env_agents", default=-1, type=int, help="Sim agents per env (-1 = IGE yaml default)")
    p.add_argument("--obs_key", default="obs", type=str, help="'obs' (deployable obs) or 'states' (full sim state)")
    p.add_argument("--subtask", default=None, type=str, help="Subtask for envs that support it (AllegroKuka)")
    p.add_argument("--eval_stats", default=False, type=str2bool, help="Collect env stats during evaluation")


# per-task tuned hyperparameters (reference train_isaacgym.py env_configs)
ENV_CONFIGS = dict(
    Ant=dict(encoder_mlp_layers=[256, 128, 64], experiment_summaries_interval=3, save_every_sec=15),
    Anymal=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[256, 128, 64], num_epochs=5,
        max_grad_norm=1.0, num_batches_per_epoch=4, exploration_loss_coeff=0.0,
    ),
    AnymalTerrain=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[256, 128, 64], num_epochs=5,
        max_grad_norm=1.0, num_batches_per_epoch=4, exploration_loss_coeff=0.001,
    ),
    BallBalance=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[128, 64, 32], num_epochs=5,
        max_grad_norm=1.0, num_batches_per_epoch=8, exploration_loss_coeff=0.0,
    ),
    Cartpole=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[128, 64, 32], num_epochs=5,
        max_grad_norm=1.0, num_batches_per_epoch=8, exploration_loss_coeff=0.0,
    ),
    ShadowHand=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[512, 512, 256, 128], learning_rate=5e-4,
        lr_schedule_kl_threshold=0.016, num_epochs=5, max_grad_norm=1.0, num_batches_per_epoch=8,
    ),
    Humanoid=dict(
        train_for_env_steps=1_310_000_000, encoder_mlp_layers=[400, 200, 100], rollout=32, num_epochs=5,
        value_loss_coeff=4.0, max_grad_norm=1.0, num_batches_per_epoch=4,
        experiment_summaries_interval=3, save_every_sec=15,
    ),
    AllegroHand=dict(
        train_for_env_steps=10_000_000_000, encoder_mlp_layers=[512, 256, 128], learning_rate=5e-3,
        lr_schedule_kl_threshold=0.02, reward_scale=0.01, num_epochs=4, max_grad_norm=1.0,
        num_batches_per_epoch=8,
    ),
    AllegroHandLSTM=dict(
        train_for_env_steps=10_000_000_000, encoder_mlp_layers=[512, 256, 128], use_rnn=True,
        rnn_type="lstm", learning_rate=1e-4, lr_schedule_kl_threshold=0.016, reward_scale=0.01,
        num_epochs=4, max_grad_norm=1.0, num_batches_per_epoch=8, obs_key="states",
    ),
)


def isaacgym_override_defaults(env, parser):
    parser.set_defaults(
        batched_sampling=True,
        num_workers=1,
        num_envs_per_worker=1,
        worker_num_splits=1,
        train_for_env_steps=10_000_000,
        use_rnn=False,
        adaptive_stddev=False,
        reward_scale=0.01,
        rollout=16,
        max_grad_norm=0.0,
        batch_size=32768,
        num_batches_per_epoch=2,
        num_epochs=4,
        ppo_clip_ratio=0.2,
        value_loss_coeff=2.0,
        exploration_loss_coeff=0.0,
        nonlinearity="elu",
        learning_rate=3e-4,
        lr_schedule="kl_adaptive_epoch",
        lr_schedule_kl_threshold=0.008,
        shuffle_minibatches=False,
        gamma=0.99,
        gae_lambda=0.95,
        with_vtrace=False,
        value_bootstrap=True,
        normalize_input=True,
        normalize_returns=True,
        save_best_after=int(5e6),
        serial_mode=True,
        async_rl=False,
        use_env_info_cache=True,
    )
    if env in ENV_CONFIGS:
        parser.set_defaults(**ENV_CONFIGS[env])


def register_isaacgym_components() -> None:
    register_isaacgym_envs()


def parse_isaacgym_args(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    add_isaacgym_env_args(partial_cfg.env, parser)
    isaacgym_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main(argv=None) -> int:
    from sample_factory_tpu_torch.train import run_rl

    register_isaacgym_components()
    cfg = parse_isaacgym_args(argv)
    return run_rl(cfg, register_fn=register_isaacgym_components)


if __name__ == "__main__":
    sys.exit(main())
