"""SLURM launcher backend: one sbatch job per experiment.

Parity: reference `sample_factory/launcher/run_slurm.py` (sbatch templating,
per-experiment working dirs, optional sbatch file customization).
"""

from __future__ import annotations

import argparse
import os
import subprocess
from os.path import join

from sample_factory_tpu_torch.utils.utils import log

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --output={logdir}/slurm-%j.out
#SBATCH --time={timeout}
#SBATCH --cpus-per-task={cpus}
#SBATCH --partition={partition}
{extra_directives}
{env_exports}
{cmd}
"""


def add_slurm_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--slurm_gpus_per_job", default=0, type=int, help="Accelerators per job")
    parser.add_argument("--slurm_cpus_per_gpu", default=16, type=int, help="CPUs per accelerator")
    parser.add_argument("--slurm_partition", default="gpu", type=str, help="Partition name")
    parser.add_argument("--slurm_timeout", default="0", type=str, help="Job time limit")
    parser.add_argument("--slurm_sbatch_template", default=None, type=str, help="Custom sbatch template file")
    parser.add_argument("--slurm_print_only", action="store_true", help="Print sbatch scripts, do not submit")
    return parser


def run_slurm(run_description, args) -> int:
    workdir = join(args.train_dir, "slurm")
    os.makedirs(workdir, exist_ok=True)

    template = SBATCH_TEMPLATE
    if args.slurm_sbatch_template:
        with open(args.slurm_sbatch_template) as f:
            template = f.read()

    experiments = list(run_description.generate_experiments(args.train_dir))
    for i, (cmd, name, root_dir, env_vars) in enumerate(experiments):
        env_exports = "\n".join(f"export {k}={v}" for k, v in (env_vars or {}).items())
        script = template.format(
            job_name=name[:64],
            logdir=workdir,
            timeout=args.slurm_timeout,
            cpus=max(1, args.slurm_cpus_per_gpu * max(1, args.slurm_gpus_per_job)),
            partition=args.slurm_partition,
            extra_directives="",
            env_exports=env_exports,
            cmd=cmd,
        )
        path = join(workdir, f"sbatch_{i:04d}_{name[:48]}.sh")
        with open(path, "w") as f:
            f.write(script)
        if args.slurm_print_only:
            log.info("sbatch script: %s\n%s", path, script)
        else:
            out = subprocess.check_output(["sbatch", path]).decode().strip()
            log.info("Submitted %s: %s", name, out)
    return 0
