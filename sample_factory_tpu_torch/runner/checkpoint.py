"""Checkpointing: atomic torch.save snapshots with rotation, milestones, best.

Counterpart of `sample_factory_tpu/runner/checkpoint.py` (reference
`sample_factory/algo/learning/learner.py:300-386`): the same payload fields
{train_state, env_steps, best_performance, train_step}, written to a temp
file and renamed (:43-83), rotated by --keep_checkpoints. The train state
holds the model, the optimizer, the normalizers and the learning rate.
`restore_from_jax_checkpoint` takes a train state from a checkpoint file of the
JAX package instead (the parameters and normalizers; not the optimizer state);
`load_checkpoint` calls it for a `.msgpack` file found in the directory.

A file always holds the whole train state. Under tensor parallelism the runner gathers the
shards before a save (`full_state_dict`, on every rank of the model group), and a load keeps
this rank's shards of what it reads; so a checkpoint resumes, plays back and exports at any
`--mesh_model`.
"""

from __future__ import annotations

import glob
import os
import time
from os.path import basename, join
from typing import List, Optional, Tuple

import numpy as np
import torch

from sample_factory_tpu_torch.utils.utils import checkpoint_dir, log


def checkpoint_name(train_step: int, env_steps: int) -> str:
    return f"checkpoint_{train_step:012d}_{env_steps}.pth"


def get_checkpoints(ckpt_dir: str, pattern: str = "checkpoint_*") -> List[str]:
    return sorted(glob.glob(join(ckpt_dir, pattern)))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = get_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = get_checkpoints(ckpt_dir, pattern="best_*")
    return ckpts[-1] if ckpts else None


def full_state_dict(train_state):
    """The whole train state: this rank's own, or, where it is sharded over the 'model' axis, its
    shards gathered over the model group (a collective: every rank of the group calls it)."""
    state = train_state.state_dict()
    return state if train_state.tp is None else train_state.tp.gather_state(state, train_state.model)


def _local_state(train_state, state):
    """This rank's part of a whole train state."""
    return state if train_state.tp is None else train_state.tp.slice_state(state, train_state.model)


def save_checkpoint(
    cfg,
    policy_id: int,
    train_state,
    env_steps: int,
    best_performance: float,
    is_best: bool = False,
    milestone: bool = False,
    state=None,
) -> str:
    """Write `state`, the whole train state (`full_state_dict`), or `train_state`'s own where none is given."""
    payload = {
        "train_state": train_state.state_dict() if state is None else state,
        "env_steps": env_steps,
        "best_performance": best_performance,
        "train_step": train_state.train_step,
    }
    d = checkpoint_dir(cfg, policy_id)
    if milestone:
        d = join(d, "milestones")
        os.makedirs(d, exist_ok=True)

    name = checkpoint_name(payload["train_step"], env_steps)
    if is_best:
        name = f"best_{name}"
    tmp = join(d, f".tmp_{name}")
    path = join(d, name)
    torch.save(payload, tmp)
    os.rename(tmp, path)  # atomic (reference :349-351)

    if not milestone:
        pattern = "best_*" if is_best else "checkpoint_*"
        keep = 1 if is_best else cfg.keep_checkpoints
        for old in get_checkpoints(d, pattern)[:-keep] if keep > 0 else []:
            try:
                os.remove(old)
            except OSError:
                pass
    return path


def load_checkpoint(cfg, policy_id: int, train_state) -> Optional[Tuple[int, float]]:
    """Load the latest (or best) checkpoint into `train_state` in place.
    Returns (env_steps, best_performance), or None when there is none. A `.msgpack` file of
    the JAX package in the directory is read through `restore_from_jax_checkpoint`, so that
    a JAX experiment resumes or plays back in the port. Retries a few times whatever the
    failure, as the JAX package does (reference :277-287)."""
    d = checkpoint_dir(cfg, policy_id, mkdir=False)
    path = best_checkpoint(d) if cfg.load_checkpoint_kind == "best" else latest_checkpoint(d)
    if path is None and cfg.load_checkpoint_kind == "best":
        path = latest_checkpoint(d)
    if path is None:
        return None

    device = next(train_state.model.parameters()).device
    error = None
    for attempt in range(3):
        try:
            if path.endswith(".msgpack"):
                return restore_from_jax_checkpoint(train_state, path)
            payload = torch.load(path, map_location=device, weights_only=True)
            train_state.load_state_dict(_local_state(train_state, payload["train_state"]))
            log.info("Loaded checkpoint %s (env_steps=%d)", basename(path), payload["env_steps"])
            return int(payload["env_steps"]), float(payload["best_performance"])
        except Exception as e:  # noqa: BLE001 - a file being written or synced; retried, then raised below
            log.warning("Checkpoint load attempt %d failed: %s", attempt + 1, e)
            error = e
            time.sleep(0.5)
    raise RuntimeError(f"Could not load checkpoint {path}") from error


def restore_from_jax_checkpoint(train_state, path: str) -> Tuple[int, float]:
    """Load a `.msgpack` checkpoint of the JAX package into `train_state` in place: the
    parameters (through the bridge), the normalizers, the learning rate, the PBT
    hyperparameters and the train step. The optimizer starts fresh: optax's moments are not
    carried. Returns (env_steps, best_performance)."""
    from sample_factory_tpu_torch import bridge

    ckpt = bridge.load_jax_checkpoint(path)
    params = bridge.flax_to_state_dict(ckpt["params"], train_state.model)
    if train_state.tp is not None:
        params = train_state.tp.slice_state({"model": params, "optimizer": {"state": {}}}, train_state.model)["model"]
    train_state.model.load_state_dict(params, strict=True)

    def as_tensors(fields):
        return {k: torch.tensor(np.array(fields[k], dtype=np.float32)) for k in ("running_mean", "running_var", "count")}

    if train_state.obs_rms is not None:
        train_state.obs_rms = {k: v.load_state_dict(as_tensors(ckpt["obs_rms"][k])) for k, v in train_state.obs_rms.items()}
    if train_state.returns_rms is not None:
        train_state.returns_rms = train_state.returns_rms.load_state_dict(as_tensors(ckpt["returns_rms"]))
    train_state.curr_lr = ckpt["curr_lr"]
    train_state.train_step = ckpt["train_step"]
    train_state.hparams = {k: ckpt["hparams"].get(k, v) for k, v in train_state.hparams.items()}
    log.info("Loaded JAX checkpoint %s (env_steps=%d)", basename(path), ckpt["env_steps"])
    return ckpt["env_steps"], ckpt["best_performance"]
