"""Launcher entry point.

Parity: reference `sample_factory/launcher/run.py` — loads a RUN_DESCRIPTION
from a module and dispatches to a backend.

Usage:
    python -m sample_factory_tpu_torch.launcher.run --run=my_module.my_sweep --backend=processes
"""

from __future__ import annotations

import argparse
import importlib
import sys

from sample_factory_tpu_torch.launcher.run_ngc import add_ngc_args, run_ngc
from sample_factory_tpu_torch.launcher.run_processes import add_os_parallelism_args, run as run_processes
from sample_factory_tpu_torch.launcher.run_slurm import add_slurm_args, run_slurm
from sample_factory_tpu_torch.utils.utils import log


def launcher_argparser(args) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dir", default="./train_dir", type=str, help="Root experiments dir")
    parser.add_argument("--run", default=None, type=str, required=True,
                        help="Module name containing RUN_DESCRIPTION (e.g. my_module.my_sweep)")
    parser.add_argument("--backend", default="processes", choices=["processes", "slurm", "ngc"])
    parser.add_argument("--experiment_suffix", default="", type=str)
    parser = add_os_parallelism_args(parser)
    parser = add_slurm_args(parser)
    parser = add_ngc_args(parser)
    return parser


def parse_args(argv=None):
    return launcher_argparser(argv).parse_args(argv)


def main() -> int:
    args = parse_args()
    try:
        run_module = importlib.import_module(args.run)
    except ImportError as e:
        log.error("Could not import module %s: %s", args.run, e)
        return 1
    run_description = run_module.RUN_DESCRIPTION
    run_description.experiment_suffix = args.experiment_suffix

    if args.backend == "processes":
        return run_processes(run_description, args)
    if args.backend == "slurm":
        return run_slurm(run_description, args)
    if args.backend == "ngc":
        return run_ngc(run_description, args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
