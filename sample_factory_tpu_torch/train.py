"""Training entry point (counterpart of `sample_factory_tpu/train.py:16-71`;
reference `sample_factory/train.py`): resolve the config, with resume-merge of
the saved config.json, build the runner and run it.

On-device envs: a single policy on a single-agent env goes to `Runner` (sync and
async, the default); `--num_policies > 1` or a multi-agent env goes to
`MultiPolicyRunner` (:46-55). Host envs: `--num_policies > 1` goes to
`HostMultiPolicyRunner`, anything else to `HostEnvRunner` (:56-63). Multi-host
runs and a device mesh of more than one device (`--mesh_data`, `--mesh_model`)
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os

from sample_factory_tpu_torch.cfg.arguments import maybe_load_from_checkpoint, verify_cfg
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
        raise NotImplementedError("multi-host runs are not ported yet (ROADMAP A13)")
    # -1 means all devices, which is the one device a run of the port has
    if cfg.mesh_model > 1 or cfg.mesh_data > 1:
        raise NotImplementedError(
            f"--mesh_data={cfg.mesh_data} --mesh_model={cfg.mesh_model}: multi-device runs are not ported yet (ROADMAP A13)"
        )

    from sample_factory_tpu_torch.envs.env_info import obtain_env_info

    env_info = obtain_env_info(cfg, register_fn=register_fn)
    if not env_info.is_device_env and env_info.num_agents > 1:
        # num_envs counts agent slots (transitions per step), like the reference's
        # total_num_agents (rl_utils.py:28-33)
        cfg.num_envs = cfg.num_workers * cfg.num_envs_per_worker * env_info.num_agents
    verify_cfg(cfg)
    if env_info.is_device_env:
        if cfg.num_policies > 1 or env_info.num_agents > 1:
            from sample_factory_tpu_torch.runner.multi_policy_runner import MultiPolicyRunner

            return cfg, MultiPolicyRunner(cfg)
        return cfg, Runner(cfg)
    if cfg.num_policies > 1:
        from sample_factory_tpu_torch.runner.host_multi_policy_runner import HostMultiPolicyRunner

        return cfg, HostMultiPolicyRunner(cfg, register_fn=register_fn)
    from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner

    return cfg, HostEnvRunner(cfg, register_fn=register_fn)


def run_rl(cfg, register_fn=None) -> int:
    _, runner = make_rl_runner(cfg, register_fn=register_fn)
    runner.init()
    return runner.run()
