"""Logging, experiment directory layout, device selection, misc helpers.

Counterpart of `sample_factory_tpu/utils/utils.py` (same experiment layout:
train_dir/<experiment>/config.json, checkpoint_p<id>/, done), with
`resolve_device` in place of the JAX platform selection.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from os.path import join
from typing import Optional

# ------------------------------------------------------------------ logging

log = logging.getLogger("sf_tpu_torch")


def _init_logger() -> None:
    if log.handlers:
        return
    log.setLevel(logging.DEBUG)
    log.propagate = False
    ch = logging.StreamHandler()
    ch.setLevel(logging.DEBUG)
    fmt = logging.Formatter("[%(asctime)s][%(process)05d] %(levelname)s %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    ch.setFormatter(fmt)
    log.addHandler(ch)


_init_logger()


def init_file_logger(cfg) -> None:
    """Mirror console logs into <experiment_dir>/sf_log.txt (reference utils.py:55-77)."""
    if not getattr(cfg, "log_to_file", True):
        return
    exp_dir = experiment_dir(cfg)
    fh = logging.FileHandler(join(exp_dir, "sf_log.txt"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("[%(asctime)s][%(process)05d] %(levelname)s %(message)s"))
    log.addHandler(fh)


# ------------------------------------------------------- experiment layout


def experiment_dir(cfg, mkdir: bool = True) -> str:
    """train_dir/<experiment>/ (reference utils.py:407-425)."""
    d = join(cfg.train_dir, cfg.experiment)
    if mkdir:
        os.makedirs(d, exist_ok=True)
    return d


def cfg_file(cfg) -> str:
    return join(experiment_dir(cfg), "config.json")


def summaries_dir(cfg, policy_id: Optional[int] = None, mkdir: bool = True) -> str:
    d = join(experiment_dir(cfg, mkdir=mkdir), ".summary")
    if policy_id is not None:
        d = join(d, str(policy_id))
    if mkdir:
        os.makedirs(d, exist_ok=True)
    return d


def checkpoint_dir(cfg, policy_id: int, mkdir: bool = True) -> str:
    """train_dir/<experiment>/checkpoint_p<id>/ (reference learner.py:323-334)."""
    d = join(experiment_dir(cfg, mkdir=mkdir), f"checkpoint_p{policy_id}")
    if mkdir:
        os.makedirs(d, exist_ok=True)
    return d


def done_filename(cfg) -> str:
    return join(experiment_dir(cfg), "done")


def save_cfg(cfg, path: Optional[str] = None) -> None:
    path = path or cfg_file(cfg)
    d = dict(vars(cfg)) if isinstance(cfg, argparse.Namespace) else dict(cfg)
    with open(path, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True, default=str)


# ------------------------------------------------------------------- misc


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str) and v.lower() in ("true", "1", "yes"):
        return True
    if isinstance(v, str) and v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}")


def resolve_device(cfg) -> "torch.device":
    """--device -> torch.device. 'gpu' is CUDA and raises when no card is visible (no
    silent CPU run); 'cpu' is the CPU; 'auto' takes CUDA when a card is visible."""
    import torch

    device = getattr(cfg, "device", "gpu")
    if device == "tpu":
        raise ValueError("--device=tpu is the JAX package's platform; the PyTorch port runs on --device=gpu or cpu")
    if device == "cpu":
        return torch.device("cpu")
    if device == "auto":
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("--device=gpu but torch.cuda.is_available() is False; pass --device=cpu to run on the CPU")
        return torch.device("cuda")
    raise ValueError(f"Unknown --device {device!r}")
