"""Play a Doom scenario yourself (keyboard, engine spectator mode).

Copy of `sf_examples_tpu/vizdoom/play_doom.py` (reference `sf_examples/vizdoom/doom/play_doom.py`).
Needs gymnasium, vizdoom and a display.

Usage:
    python -m sample_factory_tpu_torch.examples.vizdoom.play_doom --env=doom_battle [--episodes=1]
"""

from __future__ import annotations

import argparse
import sys


def main() -> int:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--env", type=str, default="doom_battle")
    parser.add_argument("--episodes", type=int, default=1)
    args = parser.parse_args()

    from sample_factory_tpu_torch.examples.vizdoom.doom.human_play import play_human
    from sample_factory_tpu_torch.examples.vizdoom.doom_utils import doom_env_by_name, make_doom_env_impl
    from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg

    spec = doom_env_by_name(args.env)
    # the Doom flags (--res_w, --res_h, ...) that the wrapper stack reads; the JAX tool's default_cfg
    # lacks them and fails with AttributeError: res_w
    cfg = parse_vizdoom_cfg([f"--env={args.env}", "--experiment=play", "--device=cpu"])
    env = make_doom_env_impl(spec, cfg=cfg, custom_resolution="1280x720")
    avg = play_human(env, max_episodes=args.episodes)
    print(f"average return over {args.episodes} episode(s): {avg:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
