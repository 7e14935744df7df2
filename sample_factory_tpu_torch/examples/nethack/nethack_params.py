"""NetHack flags and tuned defaults.

Counterpart of `sf_examples_tpu/nethack/nethack_params.py` (reference
`sf_examples/nethack/nethack_params.py`: env kwargs, model selection flags, and the
dungeons&data-matched RL hyperparameters), value for value. The defaults put an LSTM of the
cfg's `rnn_size` (512) in float32 on the learner: the grid design of the LSTM kernel
(`lstm_seq_grid`) on the card.
"""

from sample_factory_tpu_torch.utils.utils import str2bool


def add_nethack_env_args(_env, parser):
    p = parser
    p.add_argument("--character", type=str, default="mon-hum-neu-mal", help="Character role-race-align-gender")
    p.add_argument("--max_episode_steps", type=int, default=100000, help="Force-quit the game after this many steps")
    p.add_argument("--penalty_step", type=float, default=0.0, help="Penalty for frozen (no-time) steps")
    p.add_argument("--penalty_time", type=float, default=0.0, help="Penalty per in-game time unit")
    p.add_argument(
        "--fn_penalty_step",
        type=str,
        default="constant",
        help="Frozen-step penalty mode: constant|exp|square|linear|always",
    )
    p.add_argument("--savedir", type=str, default=None, help="Directory for ttyrec recordings (None = auto)")
    p.add_argument("--save_ttyrec_every", type=int, default=0, help="Save a ttyrec every Nth episode (0 = never)")
    p.add_argument("--use_prev_action", type=str2bool, default=True, help="Expose previous action as an observation")
    p.add_argument("--add_image_observation", type=str2bool, default=True, help="Add the tiled tty screen image")
    p.add_argument("--crop_dim", type=int, default=18, help="Crop size around the cursor (tty cells)")
    p.add_argument("--pixel_size", type=int, default=6, help="Pixels per tty cell in the tiled image")
    p.add_argument("--reward_win", type=float, default=1.0, help="Reward for task success (staircase/pet/oracle)")
    p.add_argument("--reward_lose", type=float, default=0.0, help="Reward for task failure (staircase/pet/oracle)")


def add_nethack_model_args(_env, parser):
    p = parser
    p.add_argument("--model", type=str, default="ChaoticDwarvenGPT5", help="Encoder: ChaoticDwarvenGPT5|ScaledNet")
    p.add_argument("--use_tty_only", type=str2bool, default=True, help="Use tty_chars for top/bottom lines")
    p.add_argument("--h_dim", type=int, default=1738, help="ScaledNet hidden dim")
    p.add_argument("--msg_hdim", type=int, default=64, help="ScaledNet message-encoder hidden dim")
    p.add_argument("--color_edim", type=int, default=16, help="ScaledNet color embedding dim")
    p.add_argument("--char_edim", type=int, default=16, help="ScaledNet char embedding dim")
    p.add_argument("--use_crop", type=str2bool, default=True, help="ScaledNet: add the cursor-crop branch")
    p.add_argument("--use_crop_norm", type=str2bool, default=True, help="ScaledNet: normalize crop convs")
    p.add_argument("--screen_kernel_size", type=int, default=3, help="ScaledNet screen conv kernel")
    p.add_argument("--no_max_pool", type=str2bool, default=False, help="ScaledNet: skip max-pooling")
    p.add_argument("--screen_conv_blocks", type=int, default=2, help="ScaledNet resnet blocks")
    p.add_argument("--blstats_hdim", type=int, default=512, help="ScaledNet blstats-encoder hidden dim")
    p.add_argument("--fc_after_cnn_hdim", type=int, default=512, help="ScaledNet screen fc hidden dim")
    p.add_argument("--use_resnet", type=str2bool, default=False, help="ScaledNet: resnet screen encoder")
    p.add_argument("--add_stats_to_info", type=str2bool, default=True, help="Blstats/task-reward episode extra stats")


def nethack_override_defaults(_env, parser):
    """Hyperparameters matched to the dungeons&data NetHack baselines."""
    parser.set_defaults(
        use_record_episode_statistics=False,
        gamma=0.999,
        num_workers=12,
        num_envs_per_worker=2,
        worker_num_splits=2,
        train_for_env_steps=2_000_000_000,
        nonlinearity="relu",
        use_rnn=True,
        rnn_type="lstm",
        actor_critic_share_weights=True,
        policy_initialization="orthogonal",
        policy_init_gain=1.0,
        adaptive_stddev=False,
        reward_scale=1.0,
        reward_clip=10.0,
        batch_size=1024,
        rollout=32,
        max_grad_norm=4.0,
        num_epochs=1,
        num_batches_per_epoch=1,
        ppo_clip_ratio=0.1,
        ppo_clip_value=1.0,
        value_loss_coeff=1.0,
        exploration_loss="entropy",
        exploration_loss_coeff=0.001,
        learning_rate=0.0001,
        gae_lambda=1.0,
        with_vtrace=False,
        normalize_input=False,
        normalize_returns=True,
        async_rl=True,
        experiment_summaries_interval=50,
        adam_beta1=0.9,
        adam_beta2=0.999,
        adam_eps=1e-7,
        batched_sampling=True,
        seed=22,
        save_every_sec=120,
    )
