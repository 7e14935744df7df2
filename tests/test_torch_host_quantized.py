"""The quantized learner of the port: the four cases of `tests/test_quantized_semantics.py`
held against the port's fused train call, one train step against the JAX package's
`QuantizedTrainer` on the same parameters and trajectory, and the behaviour snapshot of the
async host runner.

Fused and quantized run the same torch ops in the same order on one CPU thread and draw
from generators with one seed, so their parameters and stats are compared exactly. Against
JAX: float32 both sides, parameters and stats to 1e-5 (as `tests/test_torch_learner.py`).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.algo.quantized_train import QuantizedTrainer as JaxQuantizedTrainer
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.quantized_train import QuantizedTrainer
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn, normalize_obs
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole
from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticVectorDiscreteEnv
from sample_factory_tpu_torch.envs.env_info import EnvInfo, extract_env_info
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner, _QuantaPacer

torch.set_num_threads(1)


# ------------------------------------------------------------ quantized against fused


def _setup(extra):
    """The configuration of `tests/test_quantized_semantics.py:_setup`: GRU-16, 16 envs x 8
    steps, 2 minibatches of 64 in segments of 4, both normalizers; one real rollout."""
    argv = [
        "--use_rnn=True", "--rnn_size=16", "--encoder_mlp_layers", "32", "--rollout=8", "--recurrence=4", "--batch_size=64",
        "--num_epochs=1", "--num_workers=1", "--num_envs_per_worker=16", "--seed=3", "--normalize_input=True",
        "--normalize_returns=True", "--device=cpu",
    ] + list(extra)
    cfg = default_cfg(env="t", argv=argv)
    env = SyntheticVectorDiscreteEnv(num_actions=4, episode_len=6)
    env_info = extract_env_info(env, cfg)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(0))
    ts = init_train_state(cfg, env_info, model, "cpu")
    ss = init_sampler_state(cfg, env, cfg.num_envs, "cpu", torch.Generator().manual_seed(1))
    _, traj, _ = make_rollout_fn(cfg, env, env_info)(ts.model, ts.obs_rms, ss, ts.train_step, 0)
    return cfg, env_info, ts, traj


def _fresh_copy(cfg, env_info, ts):
    """A second train state with equal parameters and normalizers and its own optimizer."""
    other = init_train_state(cfg, env_info, copy.deepcopy(ts.model), "cpu")
    other.load_state_dict(copy.deepcopy(ts.state_dict()))
    return other


def _run_quantized(cfg, env_info, ts, traj, seed=1):
    q = QuantizedTrainer(cfg, env_info, 0, num_envs=cfg.num_envs)
    q.enqueue(ts, traj, torch.Generator().manual_seed(seed))
    while q.dispatch_one():
        pass
    return q, q.flush()


CASES = {
    # lr=0 freezes the parameters, so every epoch's mean policy loss is the same: both stop after 2 epochs
    "early_stop": (["--num_epochs=4", "--learning_rate=0.0", "--lr_schedule=constant"], 2),
    "runs_all_epochs_when_learning": (["--num_epochs=3", "--learning_rate=0.01"], 3),
    "shuffle_minibatches": (["--num_epochs=2", "--learning_rate=0.01", "--shuffle_minibatches=True"], 2),
    "train_step_advances_per_sgd": (["--num_epochs=2", "--learning_rate=0.01"], 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_step_equals_fused_step(case):
    extra, epochs = CASES[case]
    cfg, env_info, ts, traj = _setup(extra)
    fused_ts, quant_ts = _fresh_copy(cfg, env_info, ts), _fresh_copy(cfg, env_info, ts)
    before = copy.deepcopy(ts.model.state_dict())
    t0 = quant_ts.train_step

    fused_stats = make_train_fn(cfg, env_info)(fused_ts, traj, torch.Generator().manual_seed(1))
    q, stats = _run_quantized(cfg, env_info, quant_ts, traj)

    M = q.num_minibatches
    assert M == 2 and q.shuffle == (case == "shuffle_minibatches")
    assert float(stats["epochs_executed"]) == float(fused_stats["epochs_executed"]) == epochs
    assert q.last_sgd_steps_executed == epochs * M
    assert q.last_skipped_sgd_steps == (cfg.num_epochs - epochs) * M
    # the version contract: train_step advances by exactly the sgd quanta that ran
    assert quant_ts.train_step - t0 == q.last_sgd_steps_executed == fused_ts.train_step - t0
    assert (q.sgd_steps_per_train == q.last_sgd_steps_executed) == (case != "early_stop")
    assert quant_ts.curr_lr == fused_ts.curr_lr

    torch.testing.assert_close(quant_ts.model.state_dict(), fused_ts.model.state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(quant_ts.obs_rms["obs"].state_dict(), fused_ts.obs_rms["obs"].state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(quant_ts.returns_rms.state_dict(), fused_ts.returns_rms.state_dict(), rtol=0, atol=0)
    assert set(stats) == set(fused_stats)
    for k in stats:
        torch.testing.assert_close(stats[k], fused_stats[k], rtol=0, atol=0, msg=k)
    assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    changed = any(not torch.equal(v, before[k]) for k, v in quant_ts.model.state_dict().items())
    assert changed == (case != "early_stop")
    assert q.pending == 0 and q.total_quanta_enqueued >= 1 + epochs * (M + 1) and q.quanta_drained_at_flush == 0


def test_pacer_spreads_quanta_over_the_slots_and_bursts_when_short_of_them():
    class Queue:
        def __init__(self, n):
            self.pending = n

        def dispatch_one(self):
            self.pending -= 1
            return self.pending > 0

    q = Queue(6)
    pacer = _QuantaPacer(q, slots=12)
    pacer.reset()
    left = []
    for _ in range(12):
        pacer()
        left.append(q.pending)
    assert left == [5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0]
    q = Queue(10)
    pacer = _QuantaPacer(q, slots=4)
    pacer.reset()
    left = []
    for _ in range(4):
        pacer()
        left.append(q.pending)
    assert left == [7, 5, 2, 0]


# ------------------------------------------------------------ against the JAX QuantizedTrainer

T, N, RNN, DIM, ACTIONS = 8, 4, 16, 6, 5


def _trajectory(seed=0):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    return {
        "obs": {"obs": rng.random((T + 1, N, DIM)).astype(np.float32)},
        "rnn_states": (rng.normal(size=(T + 1, N, RNN)) * 0.5).astype(np.float32),
        "actions": rng.integers(0, ACTIONS, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, ACTIONS)).astype(np.float32),
        "log_prob_actions": np.log(rng.uniform(0.1, 0.3, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "time_outs": dones * (rng.random((T, N)) < 0.5),
        "policy_version": np.zeros((T, N), np.int32),
        # one env's last steps come from another policy -> invalid, reset in BPTT
        "policy_id": np.where((np.arange(N)[None] == 1) & (np.arange(T)[:, None] >= 5), 1, 0).astype(np.int32),
    }


def _to(traj, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in traj.items()}


@pytest.mark.parametrize("minibatches,epochs", [(2, 2), (1, 1)], ids=["2x2", "1x1"])
def test_one_quantized_train_step_matches_jax(minibatches, epochs):
    """Contiguous minibatches (the default). With one minibatch and one epoch every summary
    stat is of that minibatch on both sides and is compared; with 2 x 2 each side draws its own
    summary minibatch, so the stats that do not depend on the draw are."""
    argv = [
        "--encoder_mlp_layers", "32", f"--rnn_size={RNN}", f"--rollout={T}", "--recurrence=4", f"--batch_size={T * N // minibatches}",
        f"--num_epochs={epochs}", f"--num_envs={N}", "--normalize_input=True", "--normalize_returns=True", "--learning_rate=1e-4",
        "--seed=0",
    ]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox((DIM,))}), action_space=JDiscrete(ACTIONS), num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=make_dict_spec({"obs": Box((DIM,))}), action_space=Discrete(ACTIONS), num_agents=1, is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2, DIM))})
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    traj = _trajectory()

    jq = JaxQuantizedTrainer(jcfg, jinfo, jmodel, tx, 0, num_envs=N)
    jq.enqueue(jts, _to(traj, jnp.asarray), jax.random.PRNGKey(1))
    while jq.dispatch_one():
        pass
    jts2, jstats = jq.flush()
    tq = QuantizedTrainer(tcfg, tinfo, 0, num_envs=N)
    tq.enqueue(tts, _to(traj, torch.tensor), torch.Generator().manual_seed(1))
    while tq.dispatch_one():
        pass
    tstats = tq.flush()

    assert tq.num_minibatches == jq.num_minibatches == minibatches
    assert tq.sgd_steps_per_train == jq.sgd_steps_per_train == tq.last_sgd_steps_executed == jq.last_sgd_steps_executed
    assert tts.train_step == int(jts2.train_step) == minibatches * epochs
    assert tq.total_quanta_enqueued == jq.total_quanta_enqueued  # prepare, the sgd quanta, one lr quantum an epoch
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    start = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        assert not np.allclose(value.numpy(), start[name].numpy(), atol=1e-7), name  # every parameter moved
    np.testing.assert_allclose(tts.obs_rms["obs"].running_mean.numpy(), np.asarray(jts2.obs_rms["obs"].running_mean), atol=1e-6)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)
    assert set(tstats) == set(jstats)
    keys = set(tstats) if minibatches * epochs == 1 else {"valids_fraction", "epochs_executed", "lr", "version_diff_max"}
    for k in keys:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), atol=1e-5, rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ the behaviour snapshot


def test_async_rollout_runs_the_snapshot_while_quanta_train_the_live_module(tmp_path):
    """The optimizer updates the live module in place while the rollout is under way (the
    pacer dispatches sgd quanta between inference steps). So rollout k's `action_logits` must be
    those of the snapshot taken before train step k-1 was queued, not of the half-trained live
    module; its stamps are the snapshot's version, kept on the host."""
    reset_global_context()
    register_batched_cartpole()
    argv = [
        "--serial_mode=True", "--num_workers=2", "--num_envs_per_worker=4", "--worker_num_splits=2", "--rollout=8",
        "--batch_size=32", "--num_epochs=2", "--learning_rate=0.01", "--encoder_mlp_layers", "16", "--use_rnn=False",
        "--normalize_input=True", "--seed=2", "--device=cpu", f"--train_dir={tmp_path}", "--decorrelate_envs_on_one_worker=False",
    ]
    cfg = default_cfg(env="batched_cartpole", argv=argv)
    assert cfg.async_rl  # the default
    runner = HostEnvRunner(cfg, register_fn=register_batched_cartpole)
    runner.init()
    seen = []
    collect = runner.sampler.collect_rollout

    def recording_collect(model, obs_rms, version, policy_id=0, **kwargs):
        live = runner.train_state.model
        record = {"model": model, "version": version, "idle_fn": kwargs.get("idle_fn"),
                  "snapshot": copy.deepcopy(model), "obs_rms": obs_rms, "live_before": copy.deepcopy(live.state_dict()),
                  "train_step_before": runner.train_state.train_step}
        traj, stats = collect(model, obs_rms, version, policy_id, **kwargs)
        record.update(traj=traj, live_after=copy.deepcopy(live), train_step_after=runner.train_state.train_step)
        seen.append(record)
        return traj, stats

    runner.sampler.collect_rollout = recording_collect
    try:
        for _ in range(3):
            runner._train_iteration()
        q = runner._quantizer
        sgd = q.sgd_steps_per_train
        assert sgd == 4  # 64 transitions in 2 minibatches, 2 epochs
        assert [r["version"] for r in seen] == [0, 0, sgd]  # one train step behind, from the host mirror
        assert seen[0]["idle_fn"] is None and all(r["idle_fn"] is runner._pacer for r in seen[1:])
        for k, r in enumerate(seen):
            assert r["model"] is runner.behavior_model and r["model"] is not runner.train_state.model
            assert (r["traj"]["policy_version"] == r["version"]).all()
            obs = {"obs": r["traj"]["obs"]["obs"][:-1].reshape(-1, 4)}
            with torch.no_grad():
                want = r["snapshot"](normalize_obs(cfg, r["obs_rms"], obs), torch.zeros(obs["obs"].shape[0], 1))[0]
                live = r["live_after"](normalize_obs(cfg, runner.train_state.obs_rms, obs), torch.zeros(obs["obs"].shape[0], 1))[0]
            got = r["traj"]["action_logits"].reshape(-1, 2)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
            if k >= 1:
                # the whole train step ran inside this rollout, on the live module only
                assert r["train_step_after"] - r["train_step_before"] == sgd
                assert any(not torch.equal(v, r["live_before"][n]) for n, v in r["live_after"].state_dict().items())
                assert (got - live).abs().max() > 1e-3
        # from iteration 2 on every quantum went out inside a rollout; the first step's too
        assert q.total_quanta_enqueued == 3 * (1 + 2 * (2 + 1)) and q.quanta_drained_at_flush == 0
        assert runner._version_host == 3 * sgd and runner.train_state.train_step == 2 * sgd and q.pending > 0
        runner._finish_pending_work()
        assert runner.train_state.train_step == runner._version_host and q.pending == 0
    finally:
        runner._release_resources()
        runner._close_writers()
        reset_global_context()
