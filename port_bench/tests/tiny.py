"""The cells at sizes a CPU test can hold: the same configurations and traffic, with narrow widths and few envs."""

import json

TINY = {
    "allegro_lstm512.ppo16k": {
        "flags": {"rnn_size": 32, "encoder_mlp_layers": [32, 16], "rollout": 8, "recurrence": 8, "batch_size": 128,
                  "num_batches_per_epoch": 4},
        "model": {"core": {"type": "lstm", "size": 32}, "encoder": {"type": "mlp", "obs_dim": 88, "layers": [32, 16]}},
        "traffic": {"num_envs": 64},
    },
    "grid_gru256.ppo16k": {
        "flags": {"rnn_size": 32, "encoder_conv_mlp_layers": [32], "rollout": 8, "recurrence": 8, "batch_size": 128,
                  "num_batches_per_epoch": 1},
        "model": {"core": {"type": "gru", "size": 32},
                  "encoder": {"type": "conv", "obs_hwc": [24, 24, 3], "conv": "convnet_impala", "layers": [32]}},
        "traffic": {"num_envs": 16},
    },
}


def tiny(workload, **flags):
    out = json.loads(json.dumps(TINY[workload]))
    out["flags"].update(flags)
    return out
