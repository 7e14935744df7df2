"""Two-phase CLI parsing, resume-merge, and config verification.

Copy of `sample_factory_tpu/cfg/arguments.py` (reference `sample_factory/cfg/arguments.py` — `parse_sf_args` (:24),
`parse_full_cfg` (:55), CLI-vs-default diffing (:83-92), `preprocess_cfg`
(:97), `verify_cfg` (:105), `maybe_load_from_checkpoint` (:263)).

Two-phase contract: phase 1 builds the parser with all core flags so env
integrations can add their own flags and override defaults
(`parser.set_defaults(...)`), phase 2 produces the final AttrDict cfg. On
resume, the saved config.json is reloaded and only flags the user explicitly
passed on the CLI override it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import List, Optional, Tuple

from sample_factory_tpu_torch.cfg.cfg import add_all_args
from sample_factory_tpu_torch.utils.attr_dict import AttrDict
from sample_factory_tpu_torch.utils.utils import cfg_file, log


def parse_sf_args(
    argv: Optional[List[str]] = None, evaluation: bool = False
) -> Tuple[argparse.ArgumentParser, argparse.Namespace]:
    """Phase 1: build parser, parse known args. Returns (parser, partial_cfg)."""
    if argv is None:
        argv = sys.argv[1:]
    p = argparse.ArgumentParser(add_help=False)
    add_all_args(p)
    p.set_defaults(evaluation=evaluation)
    args, _ = p.parse_known_args(argv)
    return p, args


def parse_full_cfg(parser: argparse.ArgumentParser, argv: Optional[List[str]] = None) -> AttrDict:
    """Phase 2: final parse after env integrations added their flags."""
    if argv is None:
        argv = sys.argv[1:]
    args = parser.parse_args(argv)
    if getattr(args, "help", False):
        parser.print_help()
        sys.exit(0)
    args.command_line = " ".join(argv)
    args.cli_args = vars(_cli_only_args(parser, argv))
    cfg = postprocess_args(args)
    return cfg


def _cli_only_args(parser: argparse.ArgumentParser, argv: List[str]) -> argparse.Namespace:
    """Namespace containing only args the user explicitly passed on the CLI.

    Same trick as the reference (:83-92): re-parse with all defaults suppressed,
    so anything present was typed by the user. Used for resume-merge precedence.
    """
    no_defaults = copy.deepcopy(parser)
    no_defaults._defaults.clear()  # values injected via parser.set_defaults(...)
    for action in no_defaults._actions:
        action.default = argparse.SUPPRESS
    args, _ = no_defaults.parse_known_args(argv)
    for k in ("command_line", "cli_args", "help"):
        args.__dict__.pop(k, None)
    return args


def postprocess_args(args: argparse.Namespace) -> AttrDict:
    cfg = AttrDict(vars(args))
    cfg.pop("help", None)
    preprocess_cfg(cfg)
    return cfg


def preprocess_cfg(cfg: AttrDict) -> None:
    """Resolve derived defaults (reference :97-102)."""
    if cfg.get("recurrence", -1) == -1:
        cfg.recurrence = cfg.rollout if cfg.use_rnn else 1
    if cfg.get("num_envs", 0) <= 0:
        cfg.num_envs = cfg.num_workers * cfg.num_envs_per_worker
    if cfg.get("seed") is None:
        cfg.seed = int.from_bytes(os.urandom(4), "little")
        log.info("Generated seed %d", cfg.seed)


def verify_cfg(cfg: AttrDict) -> bool:
    """Cross-field validation (reference :105-201). Raises on fatal problems."""
    good = True
    samples_per_iteration = cfg.batch_size * cfg.num_batches_per_epoch
    samples_per_rollout = cfg.num_envs * cfg.rollout

    if not cfg.async_rl:
        # in sync mode every collected rollout must convert into an integer number of datasets
        if samples_per_rollout % samples_per_iteration != 0:
            raise ValueError(
                f"sync mode requires num_envs*rollout ({samples_per_rollout}) to be divisible by "
                f"batch_size*num_batches_per_epoch ({samples_per_iteration}); adjust num_envs/batch_size"
            )
    if cfg.with_vtrace and cfg.recurrence != cfg.rollout and cfg.use_rnn:
        raise ValueError(f"V-trace requires recurrence ({cfg.recurrence}) == rollout ({cfg.rollout})")
    if cfg.use_rnn and cfg.rollout % max(1, cfg.recurrence) != 0:
        raise ValueError(f"rollout ({cfg.rollout}) must be a multiple of recurrence ({cfg.recurrence})")
    if cfg.normalize_returns and cfg.with_vtrace:
        # same exclusion as the reference: V-trace operates on unnormalized returns
        log.warning("normalize_returns is not supported with V-trace; disabling normalize_returns")
        cfg.normalize_returns = False
    if cfg.num_epochs < 1 or cfg.num_batches_per_epoch < 1:
        raise ValueError("num_epochs and num_batches_per_epoch must be >= 1")
    if cfg.batch_size % max(1, cfg.recurrence) != 0:
        raise ValueError(f"batch_size ({cfg.batch_size}) must be a multiple of recurrence ({cfg.recurrence})")
    return good


def load_from_checkpoint(cfg: AttrDict) -> AttrDict:
    """Load saved config.json, overridden by explicitly-passed CLI args (reference :227-275)."""
    filename = cfg_file(cfg)
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"Could not load saved config {filename} (run the experiment first?)")
    with open(filename) as f:
        json_params = json.load(f)
    loaded = AttrDict(json_params)
    # user-typed CLI args take precedence over the saved experiment config
    for key, value in cfg.get("cli_args", {}).items():
        if key in ("evaluation",):
            continue
        if loaded.get(key) != value:
            log.debug("Overriding saved %s=%r with CLI value %r", key, loaded.get(key), value)
        loaded[key] = value
    # retain eval-only keys that were never saved
    for key, value in cfg.items():
        if key not in loaded:
            loaded[key] = value
    preprocess_cfg(loaded)
    return loaded


def maybe_load_from_checkpoint(cfg: AttrDict) -> AttrDict:
    filename = cfg_file(cfg)
    if not os.path.isfile(filename):
        log.warning("Saved parameter configuration for experiment %s not found!", cfg.experiment)
        log.warning("Starting experiment from scratch!")
        return cfg
    return load_from_checkpoint(cfg)


def default_cfg(env: str = "env", algo: str = "APPO", experiment: str = "test", argv: Optional[List[str]] = None) -> AttrDict:
    """Programmatic config for tests/library use."""
    argv = list(argv or [])
    argv = [f"--env={env}", f"--experiment={experiment}"] + argv
    parser, _ = parse_sf_args(argv)
    return parse_full_cfg(parser, argv)
