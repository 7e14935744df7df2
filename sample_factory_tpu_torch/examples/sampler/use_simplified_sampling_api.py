"""Standalone trajectory collection with the simplified sampling API.

Counterpart of `sf_examples_tpu/sampler/use_simplified_sampling_api.py` (reference
`sf_examples/sampler/use_simplified_sampling_api.py`): collect raw trajectories with
SyncSamplingAPI (no learner attached) and print throughput. Works with any registered
env; defaults to the Atari components like the reference, and falls back to the
synthetic on-device env when ALE is not installed, so the example always runs.

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.sampler.use_simplified_sampling_api \
        --env=atari_breakout --experiment=sampler_demo --sample_env_steps=1000000
"""

from __future__ import annotations

import sys
import time
from collections import deque

from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI
from sample_factory_tpu_torch.utils.utils import log


def _samples_per_trajectory(trajectory) -> int:
    rewards = trajectory["rewards"]  # time-major [T, N]
    return int(rewards.shape[0]) * int(rewards.shape[1])


def _print_fps_stats(cfg, fps_stats) -> None:
    delta_sampled = fps_stats[-1][1] - fps_stats[0][1]
    delta_time = fps_stats[-1][0] - fps_stats[0][0]
    fps = delta_sampled / max(delta_time, 1e-9)
    frameskip = getattr(cfg, "env_frameskip", 1) or 1
    skip_str = f" ({fps * frameskip:.1f} FPS with frameskip)" if frameskip > 1 else ""
    log.debug(f"Samples collected: {fps_stats[-1][1]}, throughput: {fps:.1f} FPS{skip_str}")


def generate_trajectories(cfg, register_fn, sample_env_steps: int = 1_000_000) -> int:
    sampler = SyncSamplingAPI(cfg, register_fn=register_fn)
    sampler.start()

    fps_stats = deque([(time.time(), 0)], maxlen=10)
    sampled = 0
    last_print = time.time()
    try:
        while sampled < sample_env_steps:
            trajectory = sampler.get_trajectories_sync()
            if trajectory is None:
                break
            sampled += _samples_per_trajectory(trajectory)
            if time.time() - last_print > 1.0:
                fps_stats.append((time.time(), sampled))
                _print_fps_stats(cfg, fps_stats)
                last_print = time.time()
    except KeyboardInterrupt:
        log.info("KeyboardInterrupt in generate_trajectories()")
    finally:
        sampler.stop()
    return 0


def _components():
    try:
        import ale_py  # noqa: F401

        from sample_factory_tpu_torch.examples.atari.train_atari import parse_atari_args, register_atari_components

        return parse_atari_args, register_atari_components
    except ImportError:
        log.warning("ALE not installed; falling back to the synthetic on-device env")
        from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

        return parse_custom_args, register_synthetic_components


def main() -> int:
    parse_args, register_components = _components()
    register_components()

    argv = [a for a in sys.argv[1:] if not a.startswith("--sample_env_steps")]
    sample_env_steps = 1_000_000
    for a in sys.argv[1:]:
        if a.startswith("--sample_env_steps="):
            sample_env_steps = int(a.split("=", 1)[1])
    cfg = parse_args(argv)
    return generate_trajectories(cfg, register_components, sample_env_steps)


if __name__ == "__main__":
    sys.exit(main())
