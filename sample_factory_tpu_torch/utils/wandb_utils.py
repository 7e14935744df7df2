"""Weights & Biases integration (gated on availability).

Counterpart of `sample_factory_tpu/utils/wandb_utils.py` (reference
`sample_factory/utils/wandb_utils.py:6-66`: init_wandb, resume by run id,
finish_wandb). Without `wandb` installed, `--with_wandb=True` warns and the run
goes on, as in the JAX package.

Two differences from the JAX module:
- the run id is a stable digest of the experiment directory (CRC-32), so that a
  resumed run finds its id again; the JAX module takes `hash()` of the path,
  which Python salts per interpreter, so `resume="allow"` never resumes there;
- `sync_tensorboard=True` would do nothing here (the port's summaries are not
  TensorBoard's own writer), so `runner/stats.py:SummaryWriter` logs every
  scalar to the open run itself.
"""

from __future__ import annotations

import os
import zlib

from sample_factory_tpu_torch.utils.utils import experiment_dir, log


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def wandb_run_id(cfg) -> str:
    """The same id for the same experiment directory in every process."""
    return f"{cfg.experiment}_{zlib.crc32(os.path.abspath(experiment_dir(cfg, mkdir=False)).encode()) % 10**8}"


def init_wandb(cfg) -> None:
    if not cfg.with_wandb:
        return
    if not wandb_available():
        log.warning("--with_wandb=True but wandb is not installed; skipping")
        return

    import wandb

    wandb.init(
        dir=cfg.wandb_dir or experiment_dir(cfg),
        project=cfg.wandb_project,
        entity=cfg.wandb_user,
        id=wandb_run_id(cfg),
        name=cfg.experiment,
        group=cfg.wandb_group,
        job_type=cfg.wandb_job_type,
        tags=list(cfg.wandb_tags or []),
        resume="allow",
        settings=wandb.Settings(start_method="fork"),
    )
    wandb.config.update(dict(cfg), allow_val_change=True)


def wandb_run(cfg):
    """The open run of `--with_wandb`, else None."""
    if not cfg.with_wandb or not wandb_available():
        return None
    import wandb

    return wandb.run


def finish_wandb(cfg) -> None:
    run = wandb_run(cfg)
    if run is not None:
        run.finish()
