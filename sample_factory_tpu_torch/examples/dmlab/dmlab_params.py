"""DMLab flags + tuned defaults.

Counterpart of `sf_examples_tpu/dmlab/dmlab_params.py` (reference
`sf_examples/dmlab/dmlab_params.py`: IMPALA-shaped config:
impala conv stack, 4-frameskip, LSTM-256 recurrent policy, rollout 32,
1 epoch; INSTR excluded from input normalization). dmlab_gpus / hardware
renderer selection is dropped, as on the JAX side: rendering is host-CPU software.
"""

import os
from os.path import join

from sample_factory_tpu_torch.utils.utils import str2bool


def dmlab_override_defaults(_env, parser):
    parser.set_defaults(
        encoder_conv_architecture="convnet_impala",
        obs_subtract_mean=0.0,
        obs_scale=255.0,
        env_frameskip=4,
        nonlinearity="relu",
        rollout=32,
        recurrence=32,
        rnn_type="lstm",
        rnn_size=256,
        use_rnn=True,
        num_epochs=1,
        batched_sampling=True,
        # never normalize the INSTR token ids (reference normalize_input_keys)
        normalize_input_keys=["obs"],
    )


def add_dmlab_env_args(_env, parser):
    p = parser
    p.add_argument("--res_w", default=96, type=int, help="Game frame width after resize")
    p.add_argument("--res_h", default=72, type=int, help="Game frame height after resize")
    p.add_argument(
        "--dmlab_throughput_benchmark",
        default=False,
        type=str2bool,
        help="Execute random policy for performance measurements",
    )
    p.add_argument(
        "--dmlab_renderer",
        default="software",
        type=str,
        choices=["software", "hardware"],
        help="DMLab renderer; software (CPU) is the normal choice",
    )
    p.add_argument(
        "--dmlab30_dataset",
        default="~/datasets/brady_konkle_oliva2008",
        type=str,
        help="Path to the image dataset some psychlab levels require",
    )
    p.add_argument("--dmlab_with_instructions", default=True, type=str2bool, help="Use text instruction observations")
    p.add_argument(
        "--dmlab_extended_action_set",
        default=False,
        type=str2bool,
        help="Use the 15-action set from the PopART/R2D2 papers instead of IMPALA's 9",
    )
    p.add_argument(
        "--dmlab_use_level_cache",
        default=True,
        type=str2bool,
        help="Reuse pre-generated levels from the local cache (highly recommended)",
    )
    p.add_argument(
        "--dmlab_level_cache_path",
        default=join(os.getcwd(), ".dmlab_cache"),
        type=str,
        help="Directory holding cached generated levels",
    )
    p.add_argument(
        "--dmlab_one_task_per_worker",
        default=False,
        type=str2bool,
        help="Assign one DMLab-30 task per worker (round-robin over workers) instead of "
        "spreading all tasks over every worker's envs; decouples sampling rates of "
        "fast and slow levels at the cost of per-task sample balance",
    )
