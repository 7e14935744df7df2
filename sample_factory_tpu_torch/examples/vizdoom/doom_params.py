"""ViZDoom hyperparameters and env args.

Counterpart of `sf_examples_tpu/vizdoom/doom_params.py` (reference
`sf_examples/vizdoom/doom/doom_params.py`: paper-tuned defaults: symmetric-KL
exploration, ppo_clip_value=0.2, frameskip 4, 128x72 frames). No `rnn_type` or
`rnn_size` is set, so a Doom policy with `--use_rnn=True` runs the cfg's defaults:
GRU-512, float32.
"""

from sample_factory_tpu_torch.utils.utils import str2bool


def add_doom_env_args(parser):
    p = parser
    p.add_argument("--num_agents", default=-1, type=int, help="Agents per match (-1 = env default)")
    p.add_argument("--num_humans", default=0, type=int, help="Human players joining the match")
    p.add_argument("--num_bots", default=-1, type=int, help="Classic bots in the match (-1 = env default)")
    p.add_argument("--start_bot_difficulty", default=None, type=int, help="Bot difficulty override")
    p.add_argument("--timelimit", default=None, type=float, help="Match time limit (minutes)")
    p.add_argument("--res_w", default=128, type=int, help="Frame width after resize")
    p.add_argument("--res_h", default=72, type=int, help="Frame height after resize")
    p.add_argument("--wide_aspect_ratio", default=False, type=str2bool, help="Render wide aspect ratio")


def add_doom_env_eval_args(parser):
    parser.add_argument("--record_to", default=None, type=str, help="Record demos to this folder")


def doom_override_defaults(parser):
    parser.set_defaults(
        ppo_clip_value=0.2,
        obs_subtract_mean=0.0,
        obs_scale=255.0,
        exploration_loss="symmetric_kl",
        exploration_loss_coeff=0.001,
        normalize_returns=True,
        normalize_input=True,
        env_frameskip=4,
        eval_env_frameskip=1,
        fps=35,
        heartbeat_reporting_interval=600,
    )
