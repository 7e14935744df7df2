"""The port end to end on the CPU: the async regime's snapshot, the learning thresholds of
the JAX package's `tests/test_e2e_training.py` through the port's `run_rl` and `enjoy`,
resume, overwrite and `eval`.

Learning runs: the JAX test's configuration (64 envs, rollout 16, batch 256, lr 3e-4, MLP
64-64 on synthetic_vector_discrete, where the best policy earns 9 x 0.01 x 16 = 1.44 an
episode and a random one 0.72), for the JAX test's 400k env steps: eager PyTorch on one
thread takes 10 s (sync) and 25 s (vtrace_rnn) for them on a CPU core. The other cases keep
the `slow` mark of their JAX twins.
"""

import csv

import pytest
import torch

from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.cfg.arguments import verify_cfg
from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.eval import do_eval
from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
from sample_factory_tpu_torch.train import make_rl_runner, run_rl
from sample_factory_tpu_torch.utils.utils import done_filename

torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    register_synthetic_components()
    yield
    reset_global_context()


def _train_cfg(tmp_path, experiment, env="synthetic_vector_discrete", extra=None):
    argv = [
        f"--env={env}",
        f"--experiment={experiment}",
        f"--train_dir={tmp_path}",
        "--seed=42",
        "--device=cpu",
        "--num_workers=4",
        "--num_envs_per_worker=16",
        "--rollout=16",
        "--batch_size=256",
        "--num_epochs=1",
        "--learning_rate=3e-4",
        "--train_for_env_steps=400000",
        "--save_every_sec=2",
        "--experiment_summaries_interval=1",
        "--save_best_after=5000",
        "--encoder_mlp_layers", "64", "64",
        "--use_rnn=False",
    ] + (extra or [])
    return parse_custom_args(argv)


def _snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_async_rollout_uses_the_snapshot_taken_before_the_train_call(tmp_path):
    """3 async iterations. The rollout of iteration k runs the behaviour module, whose
    parameters equal the learner's before its k-th train call and, the optimizer having
    updated the trained model in place, differ from the learner's after it; the trajectory
    carries the version those parameters had (4 SGD steps an iteration)."""
    cfg = _train_cfg(tmp_path, "async", extra=["--train_for_env_steps=3072", "--with_vtrace=True"])
    assert cfg.async_rl  # the default regime
    _, runner = make_rl_runner(cfg)
    runner.init()
    assert runner.behavior_model is not runner.train_state.model
    live, behaviour = list(runner.train_state.model.parameters()), list(runner.behavior_model.parameters())
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(live, behaviour))

    seen = []
    rollout_fn, train_fn = runner._rollout_fn, runner._train_fn

    def rollout(model, obs_rms, ss, version, pid):
        assert model is runner.behavior_model
        out = rollout_fn(model, obs_rms, ss, version, pid)
        seen.append({"behaviour": _snapshot(model), "version": version, "stamps": out[1]["policy_version"].clone()})
        return out

    def train(ts, traj, generator):
        seen[-1]["before"], seen[-1]["step_before"] = _snapshot(ts.model), ts.train_step
        stats = train_fn(ts, traj, generator)
        seen[-1]["after"], seen[-1]["stats"] = _snapshot(ts.model), stats
        return stats

    runner._rollout_fn, runner._train_fn = rollout, train
    assert runner.run() == 0
    assert len(seen) == 3 and runner.train_state.train_step == 12
    for k, it in enumerate(seen):
        assert it["version"] == it["step_before"] == 4 * k
        assert bool((it["stamps"] == 4 * k).all())
        assert _same(it["behaviour"], it["before"])  # the parameters from before this train call
        assert not _same(it["behaviour"], it["after"])  # which the train call then moved, in place
        assert float(it["stats"]["version_diff_max"]) == 4.0  # the lag the learner sees: never 0
        if k:
            assert _same(it["behaviour"], seen[k - 1]["after"])  # refreshed after the previous train call
    # after the last train call the snapshot was refreshed once more, by copy
    assert _same(_snapshot(runner.behavior_model), seen[-1]["after"]) and runner.behavior_version == 12
    assert not any(p.requires_grad for p in runner.behavior_model.parameters())


def test_fused_iterations_fall_back_to_one_under_async(tmp_path):
    _, runner = make_rl_runner(_train_cfg(tmp_path, "fused_async", extra=["--train_for_env_steps=2048", "--fused_iterations=4"]))
    runner.init()
    assert runner._fused_iterations == 1
    assert runner.run() == 0 and runner.env_steps == 2048
    _, runner = make_rl_runner(_train_cfg(tmp_path, "fused_sync", extra=["--train_for_env_steps=8192", "--fused_iterations=4", "--async_rl=False"]))
    runner.init()
    assert runner._fused_iterations == 4 and runner.behavior_model is None
    assert runner.run() == 0 and runner.env_steps == 8192 and runner.train_state.train_step == 32


@pytest.mark.parametrize(
    "env,extra,threshold",
    [
        ("synthetic_vector_discrete", ["--async_rl=False"], 1.3),
        pytest.param("synthetic_vector_discrete", ["--async_rl=True"], 1.3, marks=pytest.mark.slow),
        (
            "synthetic_vector_discrete",
            ["--async_rl=True", "--with_vtrace=True", "--use_rnn=True", "--rnn_size=32", "--recurrence=-1",
             "--normalize_returns=False"],
            1.2,
        ),
        pytest.param("synthetic_continuous", ["--async_rl=False", "--kl_loss_coeff=0.1"], -0.5, marks=pytest.mark.slow),
        pytest.param("synthetic_tuple", ["--async_rl=False"], -0.2, marks=pytest.mark.slow),
        pytest.param(
            "synthetic_vector_discrete",
            ["--async_rl=False", "--use_rnn=True", "--rnn_type=lstm", "--rnn_size=32", "--rnn_num_layers=2",
             "--recurrence=8", "--actor_critic_share_weights=False"],
            1.2,
            marks=pytest.mark.slow,
        ),
    ],
    ids=["sync", "async", "vtrace_rnn", "continuous", "tuple_actions", "lstm_separate_weights"],
)
def test_learns_objective(tmp_path, env, extra, threshold):
    cfg = _train_cfg(tmp_path, f"e2e_{env}", env=env, extra=extra)
    verify_cfg(cfg)
    assert run_rl(cfg) == 0

    eval_cfg = parse_custom_args(
        [f"--env={env}", f"--experiment=e2e_{env}", f"--train_dir={tmp_path}", "--no_render"], evaluation=True
    )
    status, avg_reward = enjoy(eval_cfg, num_episodes=50)
    assert status == 0
    assert avg_reward >= threshold, f"policy did not learn: avg_reward={avg_reward} < {threshold}"


@pytest.mark.parametrize(
    "env,extra",
    [
        ("synthetic_continuous", ["--adaptive_stddev=False", "--kl_loss_coeff=0.1"]),
        ("synthetic_tuple", []),
        ("synthetic_masked", ["--eval_deterministic=True"]),
        ("synthetic_discrete", ["--encoder_conv_architecture=resnet_impala", "--encoder_conv_mlp_layers", "32",
                                "--optimizer=lamb", "--lamb_lookahead=True"]),
        ("synthetic_vector_discrete", ["--use_rnn=True", "--rnn_type=lstm", "--rnn_size=16", "--rnn_num_layers=2", "--recurrence=8",
                                       "--actor_critic_share_weights=False", "--with_vtrace=False"]),
        ("ant_short", ["--normalize_input=True", "--num_epochs=2"]),
    ],
    ids=["continuous-learned-stddev", "tuple", "masked", "resnet-lamb-lookahead", "lstm-towers", "ant"],
)
def test_short_run_then_enjoy(tmp_path, env, extra):
    """Every action space, model family, optimizer and env of the slice through `run_rl`
    (the default async regime), the checkpoint and `enjoy`: 2 iterations, finite results."""
    cfg = _train_cfg(tmp_path, "short", env=env, extra=["--num_envs_per_worker=4", "--train_for_env_steps=512"] + extra)
    verify_cfg(cfg)
    _, runner = make_rl_runner(cfg)
    runner.init()
    assert runner.run() == 0 and runner.env_steps == 512
    stats = runner.host_stats()
    assert stats and all(v == v and abs(v) != float("inf") for v in stats.values()), stats
    eval_cfg = parse_custom_args([f"--env={env}", "--experiment=short", f"--train_dir={tmp_path}", "--no_render"] +
                                 [a for a in extra if a.startswith("--eval_")], evaluation=True)
    episodes = []
    status, avg_reward = enjoy(eval_cfg, num_episodes=4, num_envs=4, collect_episodes=episodes)
    assert status == 0 and avg_reward == avg_reward and len(episodes) >= 4
    assert all(length > 0 for _, length in episodes)
    if env == "synthetic_masked":
        # rewards are 0.01 x the action index: the top action (5) only when it was legal
        assert all(0.0 <= r <= 0.05 * 16 + 1e-6 for r, _ in episodes)


def test_enjoy_without_checkpoint_and_eval_csv(tmp_path):
    cfg = _train_cfg(tmp_path, "ev", extra=["--train_for_env_steps=2048"])
    assert run_rl(cfg) == 0
    eval_cfg = parse_custom_args(
        ["--env=synthetic_vector_discrete", "--experiment=ev", f"--train_dir={tmp_path}", "--sample_env_episodes=70"], evaluation=True
    )
    assert do_eval(eval_cfg) == 0
    with open(tmp_path / "ev" / "eval" / "eval_p0.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["episode", "reward", "length"] and len(rows) == 71
    assert all(int(r[2]) == 16 and 0.0 <= float(r[1]) <= 1.44 + 1e-6 for r in rows[1:])
    # another policy index has no checkpoint: status 1
    missing = parse_custom_args(
        ["--env=synthetic_vector_discrete", "--experiment=ev", f"--train_dir={tmp_path}", "--policy_index=1"], evaluation=True
    )
    assert enjoy(missing, num_episodes=1) == (1, 0.0)
    with pytest.raises(FileNotFoundError):
        enjoy(parse_custom_args(["--env=synthetic_vector_discrete", "--experiment=nope", f"--train_dir={tmp_path}"], evaluation=True))


def test_resume_from_checkpoint(tmp_path):
    cfg = _train_cfg(tmp_path, "resume_test", extra=["--train_for_env_steps=20000"])
    assert run_rl(cfg) == 0

    # second run resumes: env_steps continue from the checkpoint, and so does the snapshot's version
    cfg2 = _train_cfg(tmp_path, "resume_test", extra=["--train_for_env_steps=40000"])
    _, runner = make_rl_runner(cfg2)
    runner.init()
    assert runner.env_steps >= 20000 and runner.behavior_version == runner.train_state.train_step > 0
    assert _same(_snapshot(runner.behavior_model), _snapshot(runner.train_state.model))
    assert runner.run() == 0
    with open(done_filename(cfg2)) as f:
        assert int(f.read()) >= 40000


def test_overwrite_restart(tmp_path):
    cfg = _train_cfg(tmp_path, "ow_test", extra=["--train_for_env_steps=10000"])
    assert run_rl(cfg) == 0
    cfg2 = _train_cfg(tmp_path, "ow_test", extra=["--train_for_env_steps=10000", "--restart_behavior=overwrite"])
    _, runner = make_rl_runner(cfg2)
    runner.init()
    assert runner.env_steps == 0 and runner.train_state.train_step == 0
    assert runner.run() == 0
    with pytest.raises(RuntimeError, match="already exists"):
        make_rl_runner(_train_cfg(tmp_path, "ow_test", extra=["--restart_behavior=restart"]))
