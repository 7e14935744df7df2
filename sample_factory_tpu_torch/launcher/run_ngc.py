"""NGC (NVIDIA GPU Cloud) launcher backend.

Parity: reference `sample_factory/launcher/run_ngc.py` — each experiment of a
RUN_DESCRIPTION is templated into an `ngc batch run ...` command read from a
job-template file ({{ name }} / {{ experiment_cmd }} placeholders) and
submitted through a small thread pool. The template file is the backend
contract, so the same templating drives any other job submitter a cluster uses.
"""

from __future__ import annotations

import time
from multiprocessing.pool import ThreadPool
from subprocess import PIPE, Popen

from sample_factory_tpu_torch.utils.utils import log, str2bool


def add_ngc_args(parser):
    parser.add_argument(
        "--ngc_job_template",
        default=None,
        type=str,
        help="Job command template file; {{ name }} and {{ experiment_cmd }} are substituted per experiment",
    )
    parser.add_argument(
        "--ngc_print_only", default=False, type=str2bool, help="Print the templated commands without executing"
    )
    return parser


def render_job_command(template: str, job_name: str, experiment_cmd: str) -> str:
    """Flatten the template (line continuations, whitespace) and substitute."""
    flat = " ".join(template.replace("\\", " ").split())
    return flat.replace("{{ name }}", job_name).replace("{{ experiment_cmd }}", experiment_cmd)


def run_ngc(run_description, args) -> int:
    if args.ngc_job_template is None:
        log.error("--ngc_job_template is required for the ngc backend")
        return 1
    with open(args.ngc_job_template) as f:
        template = f.read()

    experiments = list(run_description.generate_experiments(args.train_dir, makedirs=False))
    log.info("%d experiments to submit", len(experiments))
    pause_between = getattr(args, "pause_between", 0) or 0

    def submit(idx, experiment):
        time.sleep(idx * 0.1)
        cmd, name = experiment[0], experiment[1]
        job_cmd = render_job_command(template, name, cmd)
        log.info("Submitting: %s", job_cmd)
        if not args.ngc_print_only:
            process = Popen(job_cmd, stdout=PIPE, shell=True)
            output, err = process.communicate()
            exit_code = process.wait()
            log.info("Output: %s, err: %s, exit code: %r", output, err, exit_code)
        time.sleep(pause_between)

    pool_size = 1 if pause_between > 0 else min(10, max(1, len(experiments)))
    with ThreadPool(pool_size) as pool:
        pool.starmap(submit, enumerate(experiments))
    log.info("Done!")
    return 0
