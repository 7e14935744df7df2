"""Replay a recorded .lmp Doom demo to PNG frames and an mp4.

Copy of `sf_examples_tpu/vizdoom/doom_play_demo.py` (reference
`sf_examples/vizdoom/doom/doom_play_demo.py`: the frames dir);
the mp4 is an addition. Demos are recorded during training/enjoy with
`--record_to=<dir>` (VizdoomEnv writes e###.lmp per episode,
doom/doom_env.py reset()).

Usage:
    python -m sample_factory_tpu_torch.examples.vizdoom.doom_play_demo --env=doom_battle \
        --demo_path=<dir>/e000.lmp [--fps=35] [--no_frames]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from os.path import join


def replay_demo(env_name: str, demo_path: str, fps: int = 35, write_frames: bool = True) -> str:
    import cv2

    from sample_factory_tpu_torch.utils.utils import log
    from sample_factory_tpu_torch.examples.vizdoom.doom.doom_render import for_display
    from sample_factory_tpu_torch.examples.vizdoom.doom_utils import doom_env_by_name, make_doom_env_impl
    from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg

    spec = doom_env_by_name(env_name)
    # the Doom flags (--res_w, --res_h, ...) that the wrapper stack reads; the JAX tool's default_cfg
    # lacks them and fails with AttributeError: res_w
    cfg = parse_vizdoom_cfg([f"--env={env_name}", "--experiment=play", "--device=cpu"])
    env = make_doom_env_impl(spec, cfg=cfg, render_mode="rgb_array", custom_resolution="1280x720")

    root = env.unwrapped
    root.mode = "replay"
    root._ensure_initialized()
    root.game.replay_episode(demo_path)

    frames_dir = demo_path + "_frames"
    if write_frames:
        if os.path.exists(frames_dir):
            shutil.rmtree(frames_dir)
        os.makedirs(frames_dir)

    video_path = demo_path + ".mp4"
    writer = None
    frame_id, total_reward = 0, 0.0
    while not root.game.is_episode_finished():
        _obs, reward, _done = root.advance_human_or_replay()
        img = env.render()
        if img is not None:
            bgr = for_display(img, size=None)
            if writer is None:
                writer = cv2.VideoWriter(
                    video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (bgr.shape[1], bgr.shape[0])
                )
            writer.write(bgr)
            if write_frames:
                cv2.imwrite(join(frames_dir, f"{frame_id:05d}.png"), bgr)
        frame_id += 1
        total_reward += float(reward)

    if writer is not None:
        writer.release()
    env.close()
    log.info("Replayed %d frames, total reward %.1f -> %s", frame_id, total_reward, video_path)
    return video_path


def main() -> int:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--env", type=str, required=True)
    parser.add_argument("--demo_path", type=str, required=True)
    parser.add_argument("--fps", type=int, default=35)
    parser.add_argument("--no_frames", action="store_true", help="write only the mp4, skip PNG frames")
    args = parser.parse_args()
    replay_demo(args.env, args.demo_path, fps=args.fps, write_frames=not args.no_frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
