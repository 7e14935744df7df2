"""Training entry point (counterpart of `sample_factory_tpu/train.py:16-71`;
reference `sample_factory/train.py`): resolve the config, with resume-merge of
the saved config.json, build the runner and run it.

On-device envs: a single policy on a single-agent env goes to `Runner` (sync and
async, the default); `--num_policies > 1` or a multi-agent env goes to
`MultiPolicyRunner` (:46-55). Host envs: `--num_policies > 1` goes to
`HostMultiPolicyRunner`, anything else to `HostEnvRunner` (:56-63).

`--jax_distributed=True` joins the process group that `python -m torch.distributed.run`
describes (`parallel/multihost.py`); all four runners run under it, the host runners
with each rank's own samplers feeding one data-parallel learner. A 'model' mesh axis
above 1 (tensor parallelism, `--mesh_model=M`) runs on the single-policy device-env `Runner`,
as in the JAX package; the host and population runners refuse it, since the JAX package
shards nothing there. A mesh that does not cover the processes raises. A launcher's world
of more than one process without the flag raises, so that R copies never train unaware
of each other.

    python -m torch.distributed.run --nproc_per_node=R -m sample_factory_tpu_torch.train \\
        --env=grid_battle ... --jax_distributed=True [--mesh_model=M]
    python -m torch.distributed.run --nproc_per_node=R -m sample_factory_tpu_torch.examples.train_gym_env \\
        --env=CartPole-v1 ... --jax_distributed=True
"""

from __future__ import annotations

import os
import sys

from sample_factory_tpu_torch.cfg.arguments import maybe_load_from_checkpoint, verify_cfg
from sample_factory_tpu_torch.parallel.mesh import mesh_axes
from sample_factory_tpu_torch.parallel.multihost import has_group, init_distributed, shutdown, world_size
from sample_factory_tpu_torch.runner.runner import Runner
from sample_factory_tpu_torch.utils.utils import cfg_file


def make_rl_runner(cfg, register_fn=None):
    """Resolve config + build (but do not init) the runner for cfg. Returns (cfg, runner);
    register AlgoObservers on the runner before `runner.init()`."""
    if cfg.restart_behavior == "resume" and os.path.isfile(cfg_file(cfg)):
        cfg = maybe_load_from_checkpoint(cfg)
    if cfg.restart_behavior == "restart" and os.path.isfile(cfg_file(cfg)):
        raise RuntimeError(
            f"Experiment {cfg.experiment} already exists and --restart_behavior=restart; use resume or overwrite"
        )
    if cfg.jax_distributed:
        init_distributed(cfg)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']}: a launcher started several processes, but without "
            "--jax_distributed=True each would train alone; pass the flag"
        )

    from sample_factory_tpu_torch.envs.env_info import obtain_env_info

    env_info = obtain_env_info(cfg, register_fn=register_fn)
    if not env_info.is_device_env and env_info.num_agents > 1:
        # num_envs counts agent slots (transitions per step), like the reference's
        # total_num_agents (rl_utils.py:28-33)
        cfg.num_envs = cfg.num_workers * cfg.num_envs_per_worker * env_info.num_agents
    verify_cfg(cfg)
    runner = _make_runner(cfg, env_info, register_fn)
    if cfg.mesh_model > 1 and not runner.shards_params:
        raise NotImplementedError(
            f"--mesh_model={cfg.mesh_model}: {type(runner).__name__} does not shard parameters over the 'model' axis, "
            "as the JAX package's does not (it only replicates them on its mesh); tensor parallelism runs on the "
            "single-policy device-env Runner"
        )
    mesh_axes(cfg, world_size())  # raises where --mesh_data/--mesh_model do not cover the processes
    return cfg, runner


def _make_runner(cfg, env_info, register_fn):
    if env_info.is_device_env:
        if cfg.num_policies > 1 or env_info.num_agents > 1:
            from sample_factory_tpu_torch.runner.multi_policy_runner import MultiPolicyRunner

            return MultiPolicyRunner(cfg)
        return Runner(cfg)
    if cfg.num_policies > 1:
        from sample_factory_tpu_torch.runner.host_multi_policy_runner import HostMultiPolicyRunner

        return HostMultiPolicyRunner(cfg, register_fn=register_fn)
    from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner

    return HostEnvRunner(cfg, register_fn=register_fn)


def run_rl(cfg, register_fn=None) -> int:
    """Build, init and run the runner; leaves a process group that the run joined."""
    joins = not has_group()
    try:
        _, runner = make_rl_runner(cfg, register_fn=register_fn)
        runner.init()
        return runner.run()
    finally:
        if joins:
            shutdown()


def main(argv=None) -> int:
    """The built-in on-device envs (`examples/train_synthetic.py`'s flags), alone or as one
    rank of a data-parallel run."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    return run_rl(parse_custom_args(argv))


if __name__ == "__main__":
    sys.exit(main())
