"""The learner's minibatch graphs (`algo/minibatch_graphs.py`) against the eager step, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_learner.py

(--noconftest: tests/conftest.py configures JAX). Without a card the tests skip. Two configurations at the widths of
the benchmark's cells, with fewer envs: grid-battle's convnet_impala + GRU-256 in bfloat16 (the cluster design) and
AllegroHandLSTM's MLP + LSTM-512 in float32 (the grid design, launched cooperatively).
"""

import copy
import math

import pytest
import torch

from sample_factory_tpu_torch.algo import learning
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.env_info import EnvInfo
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.models.model_utils import rnn_state_size
from sample_factory_tpu_torch.ops import cuda_rnn

torch.set_num_threads(1)

# name: (flags, obs shape, action space, the RNN's forward and backward kernels, their design)
CONFIGS = {
    "grid_gru256": (
        ["--encoder_conv_architecture=convnet_impala", "--encoder_conv_mlp_layers", "256", "--rnn_type=gru",
         "--rnn_size=256", "--compute_dtype=bfloat16", "--rollout=32", "--recurrence=32", "--num_envs=512",
         "--batch_size=4096", "--num_epochs=1", "--max_grad_norm=4.0", "--ppo_clip_ratio=0.1"],
        (24, 24, 3), Discrete(6), ("gru_seq", "gru_seq_cluster_bwd"), "cluster"),
    "allegro_lstm512": (
        ["--encoder_mlp_layers", "512", "256", "128", "--rnn_type=lstm", "--rnn_size=512", "--nonlinearity=elu",
         "--adaptive_stddev=False", "--continuous_tanh_scale=0.0", "--rollout=16", "--recurrence=16",
         "--num_envs=1024", "--batch_size=4096", "--num_epochs=2", "--lr_schedule=kl_adaptive_epoch",
         "--max_grad_norm=1.0", "--value_bootstrap=True", "--normalize_returns=True", "--value_loss_coeff=2.0"],
        (88,), Box((16,), -1.0, 1.0), ("lstm_seq_grid", "lstm_seq_grid_bwd"), "grid"),
}
CALLS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    # TF32 off as the benchmark runs; deterministic convolutions, so that two routes can agree to the last bit
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags


def _setup(name, device):
    flags, obs_shape, action_space, kernels, design = CONFIGS[name]
    cfg = default_cfg(env="e", argv=flags + ["--seed=0", "--device=gpu"])
    info = EnvInfo(obs_space=make_dict_spec({"obs": Box(obs_shape)}), action_space=action_space, num_agents=1,
                   is_device_env=True)
    model = create_actor_critic(cfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0)).to(device)
    return cfg, info, init_train_state(cfg, info, model, device), kernels, design


def _trajectory(cfg, info, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    T, N = cfg.rollout, cfg.num_envs

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    obs_shape = info.obs_space["obs"].shape
    if isinstance(info.action_space, Discrete):
        actions = torch.randint(0, info.action_space.n, (T, N, 1), generator=g, device=device).int()
        logits = normal(T, N, info.action_space.n)
        log_probs = -1.8 + 0.3 * normal(T, N)
    else:  # near the initial policy's: unit Gaussians around 0, so that few ratios are clipped
        actions = normal(T, N, 16)
        logits = torch.cat([normal(T, N, 16), normal(T, N, 16)], dim=-1) * 0.1
        log_probs = -0.5 * actions.square().sum(-1) - 8.0 * math.log(2.0 * math.pi) + 0.1 * normal(T, N)
    dones = (torch.rand((T, N), generator=g, device=device) < 0.02).float()
    policy_id = torch.zeros((T, N), dtype=torch.int32, device=device)
    policy_id[T // 2 :, : N // 16] = 1  # other policy's steps: invalid, neutralised and reset in BPTT
    return {
        "obs": {"obs": torch.rand((T + 1, N) + tuple(obs_shape), generator=g, device=device) * 255.0},
        "rnn_states": normal(T + 1, N, rnn_state_size(cfg)) * 0.5,
        "actions": actions,
        "action_logits": logits,
        "log_prob_actions": log_probs,
        "values": normal(T, N),
        "rewards": normal(T, N),
        "dones": dones,
        "time_outs": dones * (torch.rand((T, N), generator=g, device=device) < 0.5).float(),
        "policy_version": torch.zeros((T, N), dtype=torch.int32, device=device),
        "policy_id": policy_id,
    }


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graphed_minibatches_train_as_the_eager_step(cuda_device, name, monkeypatch):
    """Three train calls from the same weights on the same trajectories, once along the graph route and once along
    the eager one: every stat, gradient, Adam moment and parameter within 1e-6 of the other's; a PBT change of the
    hyperparameters before the third call captures anew, and both routes train with the new values; the optimizer's
    step post-hook fires once a minibatch; the RNN kernels' launch counts agree between the routes."""
    cfg, info, ts, kernels, design = _setup(name, cuda_device)
    T, S = cfg.recurrence, cfg.batch_size // cfg.recurrence
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    assert cuda_rnn.launch_plan(cfg.rnn_type, T, S, cfg.rnn_size, dtype).design == design
    minibatches = cfg.num_envs * cfg.rollout // cfg.batch_size
    trajs = [_trajectory(cfg, info, cuda_device, seed) for seed in range(CALLS)]
    routes = {}
    for graphed in (True, False):
        monkeypatch.setattr(learning, "replays_minibatches", lambda *a, graphed=graphed: graphed)
        run = copy.deepcopy(ts)
        train = make_train_fn(cfg, info)
        steps = []
        run.optimizer.register_step_post_hook(lambda opt, args, kwargs: steps.append(1))
        torch.cuda.synchronize()
        cuda_rnn.reset_launch_counts()
        stats, counts = [], []
        for call, traj in enumerate(trajs):
            if call == 2:
                run.hparams["ppo_clip_ratio"] *= 1.5  # as PBT changes it between train calls
            s = train(run, traj, torch.Generator(device=cuda_device).manual_seed(call))
            stats.append({k: v.clone() for k, v in s.items()})
            counts.append((train.graphs.captures, train.graphs.replays, len(steps), float(s["epochs_executed"])))
        torch.cuda.synchronize()
        routes[graphed] = run, stats, counts, cuda_rnn.launch_counts()
    (graph, graph_stats, graph_counts, graph_launches), (eager, eager_stats, eager_counts, eager_launches) = (
        routes[True], routes[False])

    epochs = [c[3] for c in eager_counts]
    assert [c[3] for c in graph_counts] == epochs
    sgd_steps = [int(sum(epochs[: i + 1]) * minibatches) for i in range(CALLS)]
    replays = [sgd_steps[0] - 1, sgd_steps[1] - 1, sgd_steps[2] - 2]  # one capture, then a replay a minibatch
    assert graph_counts == [(1, replays[0], sgd_steps[0], epochs[0]), (1, replays[1], sgd_steps[1], epochs[1]),
                            (2, replays[2], sgd_steps[2], epochs[2])]
    assert [c[:3] for c in eager_counts] == [(0, 0, n) for n in sgd_steps]
    assert graph_launches == eager_launches and all(graph_launches[k] >= sgd_steps[-1] for k in kernels)

    gaps = {}
    for call, (a, b) in enumerate(zip(graph_stats, eager_stats)):
        assert a.keys() == b.keys()
        gaps.update({f"call{call}.{k}": _gap(a[k], b[k]) for k in a})
    for (n, p), q in zip(graph.model.named_parameters(), eager.model.parameters()):
        gaps[f"param.{n}"] = _gap(p, q)
        gaps[f"grad.{n}"] = _gap(p.grad, q.grad)
        m, v = graph.optimizer.state[p], eager.optimizer.state[q]
        gaps[f"exp_avg.{n}"] = _gap(m["exp_avg"], v["exp_avg"])
        gaps[f"exp_avg_sq.{n}"] = _gap(m["exp_avg_sq"], v["exp_avg_sq"])
    worst = max(gaps, key=gaps.get)
    print(f"{name}: {len(gaps)} numbers, {sum(g == 0.0 for g in gaps.values())} equal, the largest gap "
          f"{gaps[worst]!r} ({worst})")
    assert gaps[worst] <= 1e-6, {k: g for k, g in gaps.items() if g > 1e-6}
    assert graph.curr_lr == eager.curr_lr and graph.train_step == eager.train_step == sgd_steps[-1]
