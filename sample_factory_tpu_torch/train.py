"""Training entry point (counterpart of `sample_factory_tpu/train.py:16-71`;
reference `sample_factory/train.py`): resolve the config, with resume-merge of
the saved config.json, build the runner and run it.

Ported: the single-policy runner on a single-agent on-device env, sync and
async (the default). Populations and multi-agent envs, host envs, multi-host
runs and wandb raise NotImplementedError naming their ROADMAP item.
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
    if cfg.with_wandb:
        raise NotImplementedError("--with_wandb is not ported yet (ROADMAP A14)")

    from sample_factory_tpu_torch.envs.env_info import obtain_env_info

    env_info = obtain_env_info(cfg, register_fn=register_fn)
    verify_cfg(cfg)
    if cfg.num_policies > 1 or env_info.num_agents > 1:
        raise NotImplementedError("populations and multi-agent envs are not ported yet (ROADMAP A10)")
    return cfg, Runner(cfg)


def run_rl(cfg, register_fn=None) -> int:
    _, runner = make_rl_runner(cfg, register_fn=register_fn)
    runner.init()
    return runner.run()
