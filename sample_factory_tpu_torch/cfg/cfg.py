"""Flag registry: the full CLI surface of the framework.

Copy of `sample_factory_tpu/cfg/cfg.py`: the same flag names and defaults, so
a launch script and a saved config.json serve both packages. Differences:
`--device` defaults to "gpu" and refuses "tpu"; help strings say what each
accelerator flag does in the PyTorch port.
"""

from __future__ import annotations

import multiprocessing
import os
from argparse import ArgumentParser, ArgumentTypeError
from os.path import join

from sample_factory_tpu_torch.utils.utils import str2bool


def device_arg(v: str) -> str:
    if v == "tpu":
        raise ArgumentTypeError("--device=tpu is the JAX package's platform; the PyTorch port runs on gpu (CUDA) or cpu")
    if v not in ("gpu", "cpu", "auto"):
        raise ArgumentTypeError(f"invalid --device {v!r} (choose from gpu, cpu, auto)")
    return v


def add_basic_cli_args(p: ArgumentParser) -> None:
    p.add_argument("-h", "--help", action="store_true", help="Print help and exit", required=False)
    p.add_argument("--algo", type=str, default="APPO", help="RL algorithm (APPO is the only built-in)")
    p.add_argument("--env", type=str, default=None, required=True, help="Registered environment name")
    p.add_argument("--experiment", type=str, default="default_experiment", help="Experiment name (subdir of train_dir)")
    p.add_argument("--train_dir", default=join(os.getcwd(), "train_dir"), type=str, help="Root dir for all experiments")
    p.add_argument(
        "--restart_behavior",
        default="resume",
        choices=["resume", "restart", "overwrite"],
        type=str,
        help="What to do when an experiment dir with the same name exists: resume from checkpoint, "
        "refuse to run (restart), or delete and start fresh (overwrite)",
    )
    p.add_argument(
        "--device",
        default="gpu",
        type=device_arg,
        help="Device to run on: gpu (CUDA; fails when no card is visible), cpu, or auto (CUDA when a card is "
        "visible). 'tpu' is refused: it is the JAX package's platform",
    )
    p.add_argument("--seed", default=None, type=int, help="RNG seed; None derives one from the OS")


def add_rl_args(p: ArgumentParser) -> None:
    # training system regime
    p.add_argument("--num_policies", default=1, type=int, help="Number of policies trained jointly (multi-policy / PBT)")
    p.add_argument(
        "--async_rl",
        default=True,
        type=str2bool,
        help="Collect experience with a snapshot of the policy while the learner updates the live params "
        "(policy-lag regime, V-trace/valids-aware). False = strictly on-policy sync PPO.",
    )
    p.add_argument(
        "--serial_mode",
        default=False,
        type=str2bool,
        help="Run host-side env workers inline in the main process (debugging; on-device envs are always 'serial')",
    )
    p.add_argument(
        "--batched_sampling",
        default=True,
        type=str2bool,
        help="Step all envs as one batched vector (on-device envs are always batched). Non-batched sampling "
        "emulates the reference's per-agent path for envs with heterogeneous agents/infos.",
    )
    p.add_argument(
        "--num_batches_to_accumulate",
        default=2,
        type=int,
        help="Backpressure limit: max training batches buffered before experience collection pauses (async mode)",
    )
    p.add_argument(
        "--worker_num_splits",
        default=2,
        type=int,
        help="Host-env pipeline depth (double/triple buffering of env batches feeding the device). "
        "Ignored for on-device envs.",
    )
    p.add_argument("--policy_workers_per_policy", default=1, type=int, help="Host inference threads per policy (host-env path)")
    p.add_argument("--max_policy_lag", default=1000, type=int, help="Discard experience older than this many policy versions")

    # data collection / learning regime
    p.add_argument(
        "--num_workers",
        default=multiprocessing.cpu_count(),
        type=int,
        help="Number of parallel host env workers (CPU envs only; on-device envs ignore this)",
    )
    p.add_argument("--num_envs_per_worker", default=2, type=int, help="Envs per host worker (CPU envs only)")
    p.add_argument("--batch_size", default=1024, type=int, help="SGD minibatch size (transitions)")
    p.add_argument("--num_batches_per_epoch", default=1, type=int, help="Minibatches collected per training iteration")
    p.add_argument("--num_epochs", default=1, type=int, help="SGD epochs over each collected dataset")
    p.add_argument("--rollout", default=32, type=int, help="Rollout length (timesteps per env per trajectory)")
    p.add_argument(
        "--recurrence",
        default=-1,
        type=int,
        help="BPTT length. -1 = rollout length for RNN policies, 1 for feed-forward. V-trace needs recurrence == rollout",
    )
    p.add_argument("--shuffle_minibatches", default=False, type=str2bool, help="Reshuffle minibatches every epoch")

    # basic RL parameters
    p.add_argument("--gamma", default=0.99, type=float, help="Discount factor")
    p.add_argument("--reward_scale", default=1.0, type=float, help="Multiply rewards by this before the algorithm")
    p.add_argument("--reward_clip", default=1000.0, type=float, help="Clip rewards to [-c, c] after scaling")
    p.add_argument(
        "--value_bootstrap",
        default=False,
        type=str2bool,
        help="Bootstrap returns with V(s) when an episode ends by timeout (truncation) rather than termination",
    )
    p.add_argument("--normalize_returns", default=True, type=str2bool, help="Running-mean/std normalization of returns")

    # loss components
    p.add_argument("--exploration_loss_coeff", default=0.003, type=float, help="Exploration loss coefficient")
    p.add_argument("--value_loss_coeff", default=0.5, type=float, help="Critic loss coefficient")
    p.add_argument("--kl_loss_coeff", default=0.0, type=float, help="Fixed KL(old||new) penalty coefficient")
    p.add_argument(
        "--exploration_loss",
        default="entropy",
        type=str,
        choices=["entropy", "symmetric_kl"],
        help="Exploration bonus: entropy, or symmetric KL to a uniform prior (stays finite as entropy -> 0)",
    )

    # PPO specifics
    p.add_argument("--gae_lambda", default=0.95, type=float, help="GAE lambda (used when V-trace is off)")
    p.add_argument(
        "--ppo_clip_ratio",
        default=0.1,
        type=float,
        help="PPO clip e; we use the unbiased form clip(r, 1/(1+e), 1+e)",
    )
    p.add_argument("--ppo_clip_value", default=1.0, type=float, help="Max absolute change of the value estimate before clipping")
    p.add_argument("--with_vtrace", default=False, type=str2bool, help="V-trace off-policy correction instead of GAE")
    p.add_argument("--vtrace_rho", default=1.0, type=float, help="V-trace rho_hat clipping")
    p.add_argument("--vtrace_c", default=1.0, type=float, help="V-trace c_hat clipping")

    # optimization
    p.add_argument("--optimizer", default="adam", type=str, choices=["adam", "lamb"], help="Optimizer")
    p.add_argument("--adam_eps", default=1e-6, type=float, help="Adam epsilon")
    p.add_argument("--adam_beta1", default=0.9, type=float, help="Adam beta1")
    p.add_argument("--adam_beta2", default=0.999, type=float, help="Adam beta2")
    p.add_argument(
        "--lamb_lookahead",
        default=False,
        type=str2bool,
        help="LAMB only: wrap the update in Lookahead (slow weights synced every k steps; "
        "reference optimizers.py Lamb use_look_ahead)",
    )
    p.add_argument("--lamb_lookahead_alpha", default=0.5, type=float, help="Lookahead interpolation factor")
    p.add_argument("--lamb_lookahead_k", default=10, type=int, help="Lookahead sync period (updates)")
    p.add_argument("--max_grad_norm", default=4.0, type=float, help="Global grad-norm clip; 0 disables")

    # learning rate
    p.add_argument("--learning_rate", default=1e-4, type=float, help="Learning rate")
    p.add_argument(
        "--lr_schedule",
        default="constant",
        choices=["constant", "kl_adaptive_minibatch", "kl_adaptive_epoch", "linear_decay"],
        type=str,
        help="LR schedule; kl_adaptive_* adjust LR toward --lr_schedule_kl_threshold",
    )
    p.add_argument("--lr_schedule_kl_threshold", default=0.008, type=float, help="Target KL for kl_adaptive_* schedules")
    p.add_argument("--lr_adaptive_min", default=1e-6, type=float, help="Adaptive LR lower bound")
    p.add_argument("--lr_adaptive_max", default=1e-2, type=float, help="Adaptive LR upper bound")

    # observation preprocessing
    p.add_argument("--obs_subtract_mean", default=0.0, type=float, help="Static mean subtracted from observations (e.g. 128 for RGB)")
    p.add_argument("--obs_scale", default=1.0, type=float, help="Static divisor for observations (e.g. 128 for RGB)")
    p.add_argument("--normalize_input", default=True, type=str2bool, help="Running-mean/std observation normalization")
    p.add_argument(
        "--normalize_input_keys",
        default=None,
        type=str,
        nargs="*",
        help="Observation keys to normalize (None = all)",
    )

    # experience decorrelation (host envs)
    p.add_argument("--decorrelate_experience_max_seconds", default=0, type=int, help="Host-env startup decorrelation time")
    p.add_argument("--decorrelate_envs_on_one_worker", default=True, type=str2bool, help="Stagger env resets within a worker")

    # host performance knobs (CPU-env pipeline)
    p.add_argument("--actor_worker_gpus", default=[], type=int, nargs="*", help="Accelerators for env rendering (host envs only)")
    p.add_argument("--set_workers_cpu_affinity", default=True, type=str2bool, help="Pin host env workers to cores")
    p.add_argument("--force_envs_single_thread", default=False, type=str2bool, help="Force single-threaded BLAS/OpenMP inside envs")
    p.add_argument("--default_niceness", default=0, type=int, help="Niceness of host processes")

    # logging and summaries
    p.add_argument("--log_to_file", default=True, type=str2bool, help="Also log to <experiment>/sf_log.txt")
    p.add_argument("--experiment_summaries_interval", default=10, type=int, help="Seconds between summary writes")
    p.add_argument("--flush_summaries_interval", default=30, type=int, help="Seconds between summary flushes")
    p.add_argument("--stats_avg", default=100, type=int, help="Window (episodes) for averaged stats")
    p.add_argument("--summaries_use_frameskip", default=True, type=str2bool, help="Multiply step counts by frameskip in summaries")
    p.add_argument("--heartbeat_interval", default=20, type=int, help="Seconds between host-worker heartbeats")
    p.add_argument("--heartbeat_reporting_interval", default=180, type=int, help="Seconds between runner heartbeat checks")

    # termination
    p.add_argument("--train_for_env_steps", default=int(1e10), type=int, help="Stop after this many env steps")
    p.add_argument("--train_for_seconds", default=int(1e10), type=int, help="Stop after this many seconds")

    # model saving
    p.add_argument("--save_every_sec", default=120, type=int, help="Checkpoint interval (seconds)")
    p.add_argument("--keep_checkpoints", default=2, type=int, help="Number of rotating checkpoints to keep")
    p.add_argument("--load_checkpoint_kind", default="latest", choices=["latest", "best"], help="Which checkpoint to load")
    p.add_argument("--save_milestones_sec", default=-1, type=int, help="Save milestone checkpoints this often (-1 = never)")
    p.add_argument("--save_best_every_sec", default=5, type=int, help="How often to check/save the best policy")
    p.add_argument("--save_best_metric", default="reward", help="Metric that defines 'best'")
    p.add_argument("--save_best_after", default=100000, type=int, help="Env steps before best-checkpoints start")

    # debugging
    p.add_argument("--benchmark", default=False, type=str2bool, help="Benchmark mode")


def add_model_args(p: ArgumentParser) -> None:
    p.add_argument("--encoder_mlp_layers", default=[512, 512], type=int, nargs="*", help="MLP encoder layer sizes")
    p.add_argument(
        "--encoder_conv_architecture",
        default="convnet_simple",
        choices=["convnet_simple", "convnet_impala", "convnet_atari", "resnet_impala"],
        type=str,
        help="Convolutional encoder architecture",
    )
    p.add_argument("--encoder_conv_mlp_layers", default=[512], type=int, nargs="*", help="FC layers after the conv encoder")
    p.add_argument("--use_rnn", default=True, type=str2bool, help="Use a recurrent core")
    p.add_argument("--rnn_size", default=512, type=int, help="RNN hidden size")
    p.add_argument("--rnn_type", default="gru", choices=["gru", "lstm"], type=str, help="RNN cell type")
    p.add_argument("--rnn_num_layers", default=1, type=int, help="Stacked RNN layers")
    p.add_argument("--decoder_mlp_layers", default=[], type=int, nargs="*", help="Decoder MLP between core and heads")
    p.add_argument("--nonlinearity", default="elu", choices=["elu", "relu", "tanh"], type=str, help="Activation function")
    p.add_argument(
        "--policy_initialization",
        default="orthogonal",
        choices=["orthogonal", "xavier_uniform", "torch_default"],
        type=str,
        help="Weight init scheme",
    )
    p.add_argument("--policy_init_gain", default=1.0, type=float, help="Init gain")
    p.add_argument("--actor_critic_share_weights", default=True, type=str2bool, help="Share encoder/core between actor and critic")
    p.add_argument("--adaptive_stddev", default=True, type=str2bool, help="State-dependent stddev for continuous actions")
    p.add_argument("--continuous_tanh_scale", default=0.0, type=float, help="tanh(mu/scale)*scale squashing of action means")
    p.add_argument("--initial_stddev", default=1.0, type=float, help="Initial stddev for non-adaptive continuous actions")


def add_default_env_args(p: ArgumentParser) -> None:
    p.add_argument("--use_env_info_cache", default=False, type=str2bool, help="Cache env info on disk")
    p.add_argument("--env_gpu_actions", default=False, type=str2bool, help="Env expects device-resident actions")
    p.add_argument("--env_gpu_observations", default=True, type=str2bool, help="Env returns device-resident observations")
    p.add_argument("--env_frameskip", default=1, type=int, help="Action repeat (frames)")
    p.add_argument("--env_framestack", default=1, type=int, help="Frame stacking (Atari-style)")
    p.add_argument("--pixel_format", default="CHW", type=str, help="Image layout; observations are HWC at the model's interface (convs permute to NCHW inside)")
    p.add_argument("--use_record_episode_statistics", default=False, type=str2bool, help="gym RecordEpisodeStatistics wrapper")
    p.add_argument("--episode_counter", default=False, type=str2bool, help="Count episodes per env")


def add_eval_args(p: ArgumentParser) -> None:
    p.add_argument("--fps", default=0, type=int, help="Render FPS cap (0 = unlimited)")
    p.add_argument("--eval_env_frameskip", default=None, type=int, help="Override frameskip at eval time (e.g. 1 for smooth video)")
    p.add_argument("--no_render", action="store_true", help="Disable rendering")
    p.add_argument("--save_video", action="store_true", help="Save a video instead of rendering")
    p.add_argument("--video_frames", default=1e9, type=int, help="Frames to record (-1 = until first episode done)")
    p.add_argument("--video_name", default=None, type=str, help="Video file name")
    p.add_argument("--max_num_frames", default=1e9, type=int, help="Max frames to evaluate")
    p.add_argument("--max_num_episodes", default=1e9, type=int, help="Max episodes to evaluate")
    p.add_argument("--push_to_hub", action="store_true", help="Push experiment dir to HuggingFace Hub")
    p.add_argument("--hf_repository", default=None, type=str, help="HF repo id <user>/<name>")
    p.add_argument("--policy_index", default=0, type=int, help="Which policy of the population to evaluate")
    p.add_argument("--eval_deterministic", default=False, type=str2bool, help="Argmax actions instead of sampling")
    p.add_argument("--train_script", default=None, type=str, help="Training script module (for HF model card)")
    p.add_argument("--enjoy_script", default=None, type=str, help="Enjoy script module (for HF model card)")
    p.add_argument("--sample_env_episodes", default=64, type=int, help="Episodes to sample for fast eval")
    p.add_argument("--csv_folder_name", default=None, type=str, help="Folder for eval CSV output")


def add_wandb_args(p: ArgumentParser) -> None:
    p.add_argument("--with_wandb", default=False, type=str2bool, help="Enable Weights & Biases")
    p.add_argument("--wandb_user", default=None, type=str, help="W&B entity")
    p.add_argument("--wandb_project", default="sample_factory_tpu", type=str, help="W&B project")
    p.add_argument("--wandb_group", default=None, type=str, help="W&B group")
    p.add_argument("--wandb_job_type", default="SF", type=str, help="W&B job type")
    p.add_argument("--wandb_tags", default=[], type=str, nargs="*", help="W&B tags")
    p.add_argument("--wandb_dir", default=None, type=str, help="W&B log dir")


def add_pbt_args(p: ArgumentParser) -> None:
    p.add_argument("--with_pbt", default=False, type=str2bool, help="Enable population-based training")
    p.add_argument("--pbt_mix_policies_in_one_env", default=True, type=str2bool, help="Mix different policies within one env (self-play)")
    p.add_argument("--pbt_period_env_steps", default=int(5e6), type=int, help="PBT update period per policy (env steps)")
    p.add_argument("--pbt_start_mutation", default=int(2e7), type=int, help="Env steps before mutation starts")
    p.add_argument("--pbt_replace_fraction", default=0.3, type=float, help="Bottom fraction of policies replaced")
    p.add_argument("--pbt_mutation_rate", default=0.15, type=float, help="Per-parameter mutation probability")
    p.add_argument("--pbt_replace_reward_gap", default=0.1, type=float, help="Relative reward gap required to replace")
    p.add_argument("--pbt_replace_reward_gap_absolute", default=1e-6, type=float, help="Absolute reward gap required to replace")
    p.add_argument("--pbt_optimize_gamma", default=False, type=str2bool, help="Allow PBT to mutate gamma")
    p.add_argument("--pbt_target_objective", default="true_objective", type=str, help="Metric PBT optimizes")
    p.add_argument("--pbt_perturb_min", default=1.05, type=float, help="Min perturbation factor")
    p.add_argument("--pbt_perturb_max", default=1.5, type=float, help="Max perturbation factor")


def add_tpu_args(p: ArgumentParser) -> None:
    """Accelerator settings (new vs. the reference: mesh, precision, pipeline). The names are the JAX
    package's; the help strings say what each does in the PyTorch port."""
    p.add_argument(
        "--num_envs",
        default=0,
        type=int,
        help="Total vectorized envs for on-device sampling (0 = derive from num_workers * num_envs_per_worker)",
    )
    p.add_argument(
        "--mesh_data",
        default=-1,
        type=int,
        help="Devices on the 'data' mesh axis (-1 = all available devices / mesh_model)",
    )
    p.add_argument("--mesh_model", default=1, type=int, help="Devices on the 'model' mesh axis (tensor parallelism)")
    p.add_argument(
        "--tp_min_layer_width",
        default=512,
        type=int,
        help="Smallest feature width sharded over the 'model' axis when mesh_model > 1",
    )
    p.add_argument(
        "--compute_dtype",
        default="float32",
        choices=["float32", "bfloat16"],
        type=str,
        help="Dtype for network compute (params stay float32 and are cast in the forward)",
    )
    p.add_argument(
        "--on_device_env",
        default=None,
        type=str2bool,
        help="Force on-device (jittable) or host env path; None = auto-detect from the registered env",
    )
    p.add_argument("--host_pipeline_depth", default=2, type=int, help="Host->device staging buffers for CPU envs")
    p.add_argument(
        "--fused_iterations",
        default=1,
        type=int,
        help="On-device sync training: run K rollout+train iterations per runner iteration, with "
        "episodic stats summed over them; summaries/observers fire once per block of K. "
        "Sync single-policy runner only",
    )
    p.add_argument(
        "--pallas_rnn",
        default=False,
        type=str2bool,
        help="Accepted so that JAX-side configs load; no effect in the PyTorch port: the BPTT recurrence "
        "always runs the hand-written CUDA kernel on the card (ops/cuda_rnn.py) and its plain version "
        "on the CPU",
    )
    p.add_argument(
        "--jax_distributed",
        default=False,
        type=str2bool,
        help="Data-parallel run on torch.distributed, one process a device, started by python -m torch.distributed.run "
        "(NCCL on the card, gloo on the CPU); the envs of --num_envs are split over the ranks",
    )
    p.add_argument("--profiler_dir", default=None, type=str, help="If set, capture a torch.profiler trace of the first iterations into this dir")


def add_all_args(p: ArgumentParser) -> None:
    add_basic_cli_args(p)
    add_rl_args(p)
    add_model_args(p)
    add_default_env_args(p)
    add_eval_args(p)
    add_wandb_args(p)
    add_pbt_args(p)
    add_tpu_args(p)
