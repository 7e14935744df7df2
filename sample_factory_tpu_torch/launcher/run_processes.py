"""Local-process launcher backend.

Parity: reference `sample_factory/launcher/run_processes.py:14-142` (process
pool with max parallelism and accelerator packing). Each experiment gets the
least busy of `--num_devices` cards through CUDA_VISIBLE_DEVICES, unless its own
env vars set that already.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import time
from os.path import join
from typing import List

from sample_factory_tpu_torch.utils.utils import log


def add_os_parallelism_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--max_parallel", default=4, type=int, help="Maximum simultaneous experiments")
    parser.add_argument("--experiments_per_device", default=1, type=int, help="Experiments packed per accelerator")
    parser.add_argument("--num_devices", default=1, type=int, help="Accelerators available to the launcher")
    return parser


def run(run_description, args) -> int:
    experiments = list(run_description.generate_experiments(args.train_dir))
    log.info("Starting processes with base cmds: %r", [e[0] for e in experiments])

    processes: List[subprocess.Popen] = []
    device_of: dict = {}
    device_load = {i: 0 for i in range(args.num_devices)}
    next_experiment = 0

    def least_busy_device() -> int:
        return min(device_load, key=lambda d: device_load[d])

    try:
        while next_experiment < len(experiments) or processes:
            # reap finished
            still_running = []
            for p in processes:
                if p.poll() is None:
                    still_running.append(p)
                else:
                    device_load[device_of.pop(p.pid, 0)] -= 1
                    log.info("Process %d finished with code %d", p.pid, p.returncode)
            processes = still_running

            while next_experiment < len(experiments) and len(processes) < args.max_parallel:
                cmd, name, root_dir, env_vars = experiments[next_experiment]
                device = least_busy_device()
                if device_load[device] >= args.experiments_per_device:
                    break
                env = os.environ.copy()
                env["CUDA_VISIBLE_DEVICES"] = str(device)
                if env_vars:
                    env.update(env_vars)
                log.info("Launching [%s] on device %d: %s", name, device, cmd)
                with open(join(args.train_dir, f"{name}.log"), "w") as logfile:  # the child keeps its own descriptor
                    p = subprocess.Popen(shlex.split(cmd), env=env, stdout=logfile, stderr=subprocess.STDOUT)
                device_of[p.pid] = device
                device_load[device] += 1
                processes.append(p)
                next_experiment += 1

            time.sleep(1.0)
    except KeyboardInterrupt:
        log.info("Interrupted; terminating child processes")
        for p in processes:
            p.terminate()
        return 1
    log.info("All experiments finished")
    return 0
