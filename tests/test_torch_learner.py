"""The training slice as a whole: one learner update of the port against the JAX
package on the same parameters and the same trajectory, and the port's
`run_rl` end to end on the CPU (checkpoint, resume, no JAX imported).

The update runs a 36x36 observation through convnet_impala (a 3x3x32 map), a
GRU-32 core over BPTT segments with mid-segment dones and invalid steps, the
PPO losses, gradient clipping and Adam. Both sides compute in float32; the
parameters after the update agree to 1e-5 (Adam's first steps move each
parameter by about lr * sign(grad), so a float32 summation-order difference
in a near-zero gradient component can only move that component by a
fraction of lr = 1e-4).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.learning import build_train_pieces as jax_build_train_pieces
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.learning import build_train_pieces, init_train_state, make_train_fn
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.env_info import EnvInfo
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N, RNN, OBS = 8, 4, 32, (36, 36, 3)


def _trajectory(seed=0, versions=None):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    return {
        "obs": {"obs": rng.random((T + 1, N) + OBS).astype(np.float32)},
        "rnn_states": (rng.normal(size=(T + 1, N, RNN)) * 0.5).astype(np.float32),
        "actions": rng.integers(0, 6, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, 6)).astype(np.float32),
        "log_prob_actions": np.log(rng.uniform(0.1, 0.3, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "time_outs": dones * (rng.random((T, N)) < 0.5),
        # one env's last steps come from another policy -> invalid, reset in BPTT
        "policy_version": np.zeros((T, N), np.int32) if versions is None else versions.astype(np.int32),
        "policy_id": np.where((np.arange(N)[None] == 1) & (np.arange(T)[:, None] >= 5), 1, 0).astype(np.int32),
    }


def _to(traj, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in traj.items()}


def _setup(extra):
    argv = [
        "--encoder_conv_architecture=convnet_impala",
        "--encoder_conv_mlp_layers", "32",
        f"--rnn_size={RNN}",
        f"--rollout={T}",
        f"--recurrence={T}",
        "--batch_size=16",
        f"--num_envs={N}",
        "--async_rl=False",
        "--normalize_input=True",
        "--learning_rate=1e-4",
        "--seed=0",
    ] + list(extra)
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox(OBS)}), action_space=JDiscrete(6), num_agents=1, is_device_env=True)
    tinfo = EnvInfo(obs_space=make_dict_spec({"obs": Box(OBS)}), action_space=Discrete(6), num_agents=1, is_device_env=True)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2,) + OBS)})
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    return (jcfg, jinfo, jmodel, tx, jts), (tcfg, tinfo, tts)


@pytest.mark.parametrize("extra", [[], ["--num_epochs=2", "--value_bootstrap=True"]], ids=["1epoch", "2epochs-bootstrap"])
def test_one_train_call_matches_jax(extra):
    (jcfg, jinfo, jmodel, tx, jts), (tcfg, tinfo, tts) = _setup(extra)
    traj = _trajectory()
    jtraj, ttraj = _to(traj, jnp.asarray), _to(traj, torch.tensor)

    # prepare_batch alone: valids, obs normalization, bootstrap value, GAE, returns normalization
    _, jax_prepare = jax_build_train_pieces(jcfg, jinfo, jmodel, tx)
    _, jdata, jfrac = jax.jit(jax_prepare, static_argnums=2)(jts, jtraj, 0)
    _, prepare = build_train_pieces(tcfg, tinfo)
    _, fresh = _setup(extra)
    tdata, tfrac = prepare(fresh[2], ttraj, 0)
    assert tfrac == pytest.approx(float(jfrac)) and tfrac < 1.0
    for key in ("advantages", "returns", "valids", "log_prob_actions"):
        np.testing.assert_allclose(tdata[key].numpy(), np.asarray(jdata[key]), atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tdata["normalized_obs"]["obs"].numpy(), np.asarray(jdata["normalized_obs"]["obs"]), atol=1e-5)

    # the whole train call: both minibatches (and epochs), clip, Adam
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, jtraj, jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, ttraj, torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 2 * jcfg.num_epochs
    assert float(tstats["epochs_executed"]) == float(jstats["epochs_executed"])
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    moved = 0
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        moved += int(not np.allclose(value.numpy(), bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts.params), tts.model)[name].numpy()))
    assert moved == len(want)  # every parameter took part in the update
    jrms, trms = jts2.obs_rms["obs"], tts.obs_rms["obs"]
    np.testing.assert_allclose(trms.running_mean.numpy(), np.asarray(jrms.running_mean), atol=1e-6)
    np.testing.assert_allclose(trms.running_var.numpy(), np.asarray(jrms.running_var), atol=1e-6)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)
    for key in ("grad_norm", "valids_fraction", "lr"):
        assert np.isfinite(float(tstats[key]))


def test_vtrace_update_with_policy_lag_matches_jax():
    """One train call under --with_vtrace (GRU, recurrence == rollout) at train step 10 with
    --max_policy_lag=5: env 2 was collected at version 3 (lag 7, masked out as a whole) and
    env 3's first steps at version 5 (lag 5, masked), the rest at version 8. Parameters and
    stats against the JAX train call: 1e-5, as for GAE above."""
    extra = ["--with_vtrace=True", "--vtrace_rho=0.9", "--vtrace_c=1.1", "--max_policy_lag=5", "--normalize_returns=False"]
    (jcfg, jinfo, jmodel, tx, jts), (tcfg, tinfo, tts) = _setup(extra)
    versions = np.full((T, N), 8)
    versions[:, 2] = 3
    versions[:3, 3] = 5
    traj = _trajectory(versions=versions)
    jtraj, ttraj = _to(traj, jnp.asarray), _to(traj, torch.tensor)
    jts = jts.replace(train_step=jnp.asarray(10, jnp.int32))
    tts.train_step = 10
    assert tts.returns_rms is None and jts.returns_rms is None

    _, jax_prepare = jax_build_train_pieces(jcfg, jinfo, jmodel, tx)
    _, jdata, jfrac = jax.jit(jax_prepare, static_argnums=2)(jts, jtraj, 0)
    _, prepare = build_train_pieces(tcfg, tinfo)
    _, fresh = _setup(extra)
    fresh[2].train_step = 10
    tdata, tfrac = prepare(fresh[2], ttraj, 0)
    valids = tdata["valids"].reshape(N, T)
    assert valids[2].sum() == 0 and valids[3, :3].sum() == 0 and valids[0].sum() == T  # the lag mask, from the tensor
    np.testing.assert_array_equal(tdata["valids"].numpy(), np.asarray(jdata["valids"]))
    assert tfrac == pytest.approx(float(jfrac))
    assert not tdata["advantages"].any() and not tdata["returns"].any()  # V-trace computes them per minibatch

    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, jtraj, jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, ttraj, torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 12
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    assert float(tstats["version_diff_max"]) == float(jstats["version_diff_max"]) == 9.0
    # the summary minibatch is drawn by each side's own generator: compare what does not depend on it
    for key in ("valids_fraction", "epochs_executed", "lr"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), atol=1e-5, err_msg=key)


def test_vtrace_minibatch_stats_match_jax():
    """compute_losses under V-trace on one minibatch, every stat against JAX: 1e-5."""
    extra = ["--with_vtrace=True", "--vtrace_rho=0.9", "--max_policy_lag=5", "--normalize_returns=False", "--batch_size=32"]
    (jcfg, jinfo, jmodel, tx, jts), (tcfg, tinfo, tts) = _setup(extra)
    versions = np.full((T, N), 8)
    versions[:, 2] = 3
    traj = _trajectory(versions=versions)
    jts = jts.replace(train_step=jnp.asarray(10, jnp.int32))
    tts.train_step = 10
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, _to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, _to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert set(tstats) == set(jstats)  # one minibatch an epoch: both summaries are of that minibatch
    for key, value in tstats.items():
        np.testing.assert_allclose(float(value), float(jstats[key]), atol=1e-5, rtol=1e-5, err_msg=key)


def _invariants_setup(extra=()):
    """`tests/test_learner_invariants.py:_setup` in the port: the synthetic env (4 actions,
    episodes of 6 steps), MLP 32 + GRU-16, 16 envs x 8 steps over BPTT segments of 4, and
    one rollout of the initial parameters."""
    from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
    from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticVectorDiscreteEnv
    from sample_factory_tpu_torch.envs.env_info import extract_env_info

    argv = ["--use_rnn=True", "--rnn_size=16", "--encoder_mlp_layers", "32", "--rollout=8", "--recurrence=4",
            "--batch_size=64", "--num_epochs=1", "--num_envs=16", "--seed=3", "--normalize_input=True",
            "--normalize_returns=True", "--device=cpu"] + list(extra)
    cfg = default_cfg(env="t", argv=argv)
    env = SyntheticVectorDiscreteEnv(num_actions=4, episode_len=6)
    info = extract_env_info(env, cfg)
    ts = init_train_state(cfg, info, create_actor_critic(cfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0)), "cpu")
    ss = init_sampler_state(cfg, env, cfg.num_envs, "cpu", torch.Generator().manual_seed(1))
    _, traj, _ = make_rollout_fn(cfg, env, info)(ts.model, ts.obs_rms, ss, 0, 0)
    return cfg, info, ts, traj


def test_train_is_deterministic():
    """`tests/test_learner_invariants.py::test_train_is_deterministic`: two train calls on one
    input agree bit for bit (the replicas of a data-parallel run rest on it)."""
    cfg, info, ts, traj = _invariants_setup()
    train = make_train_fn(cfg, info)
    runs = [copy.deepcopy(ts) for _ in range(2)]
    stats = [train(run, traj, torch.Generator().manual_seed(1)) for run in runs]
    assert float(stats[0]["loss"]) == float(stats[1]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(*(run.model.state_dict().values() for run in runs)))
    assert all(torch.equal(a, b) for a, b in zip(*(run.obs_rms["obs"].state_dict().values() for run in runs)))


def test_invalid_data_does_not_change_update():
    """`tests/test_learner_invariants.py::test_invalid_data_does_not_change_update` (:54-96):
    garbage transitions (values of 0 and -4242, `policy_id` -1) beside the real ones, in a
    minibatch twice as large, leave the losses and the gradient of the one minibatch as
    they were. Normalizers off, so that the garbage cannot move their moments."""
    common = ["--normalize_input=False", "--normalize_returns=False"]
    cfg, info, ts, traj = _invariants_setup(common + ["--batch_size=128"])
    base = make_train_fn(cfg, info)(ts, traj, torch.Generator().manual_seed(1))
    cfg2, info2, ts2, traj2 = _invariants_setup(common + ["--batch_size=256"])
    rng = np.random.default_rng(0)

    def splice(x):
        garbage = torch.as_tensor(rng.integers(-1, 1, size=tuple(x.shape)) * 4242).to(x.dtype)
        return torch.cat([x, garbage], dim=1)

    n = traj2["rewards"].shape[1]
    spliced = _to(traj2, splice)
    spliced["policy_id"][:, n:] = -1  # the inactive-agent marker: invalid
    for key in ("dones", "time_outs"):
        spliced[key][:, n:] = 0.0
    stats = make_train_fn(cfg2, info2)(ts2, spliced, torch.Generator().manual_seed(1))
    assert float(stats["valids_fraction"]) == 0.5
    for key in ("policy_loss", "exploration_loss", "value_loss", "kl_divergence", "entropy", "adv_mean", "adv_std", "grad_norm"):
        np.testing.assert_allclose(float(stats[key]), float(base[key]), rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("device,distributed,tp,shuffle,graphed", [
    ("cuda", False, None, False, True),
    ("cpu", False, None, False, False),
    ("cuda", True, None, False, False),
    ("cuda", False, "layout", False, False),
    ("cuda", False, None, True, False),
], ids=["one-card-rank", "cpu", "ranks", "tensor-parallel", "shuffled"])
def test_minibatch_graph_route(device, distributed, tp, shuffle, graphed):
    """The minibatches replay as CUDA graphs on one CUDA rank with contiguous minibatches, and nowhere else."""
    from types import SimpleNamespace

    from sample_factory_tpu_torch.algo.minibatch_graphs import replays_minibatches

    cfg = SimpleNamespace(shuffle_minibatches=shuffle)
    assert replays_minibatches(cfg, torch.device(device), distributed, tp) is graphed


@pytest.mark.parametrize("change", ["none", "hparams", "dataset-size", "parameter"])
def test_minibatch_graph_key(change):
    """The graph's key holds over a new dataset of the same shapes, and changes with the PBT hyperparameters, a
    dataset smaller than the batch (the batch is clipped to it) and a parameter's tensor."""
    from sample_factory_tpu_torch.algo.minibatch_graphs import graph_key

    cfg, info, ts, traj = _invariants_setup()
    _, prepare_batch = build_train_pieces(cfg, info)
    for p in ts.model.parameters():
        p.grad = torch.zeros_like(p)

    def key(traj):
        dataset, _ = prepare_batch(ts, traj, 0)
        return graph_key(ts, dataset, min(cfg.batch_size, dataset["valids"].shape[0]))

    before = key(traj)
    if change == "hparams":
        ts.hparams["ppo_clip_ratio"] = 0.3
    if change == "dataset-size":
        traj = _to(traj, lambda x: x[:, : x.shape[1] // 4])
    if change == "parameter":
        p = next(ts.model.parameters())
        p.data = p.data.clone()
    assert (key(_to(traj, lambda x: x.clone())) == before) is (change == "none")


def _replaying_capture(self, inputs, step):
    """A CPU stand-in of MinibatchGraphs._capture: step() runs on a copy of the inputs for the call's results and
    again for the graph's outputs; a "replay" runs step() once more and writes what it returns into those outputs, as
    a graph's replay writes into its own."""
    from sample_factory_tpu_torch.algo.minibatch_graphs import _Graph

    static = _to(inputs, lambda x: x.clone())
    (aux, grad_norm), (static_aux, static_norm) = step(static), step(static)

    class Replay:
        def replay(self):
            new_aux, new_norm = step(static)
            torch._foreach_copy_(list(static_aux.values()) + [static_norm], list(new_aux.values()) + [new_norm])

    return aux, grad_norm, _Graph(Replay(), static, static_aux, static_norm, {})


def test_minibatch_graphs_train_as_the_eager_step(monkeypatch):
    """Three train calls of 2 epochs of 2 minibatches along the graph route (the graph's CPU stand-in) and along
    the eager one give the same stats, parameters and Adam moments, bit for bit; the graph route captures once,
    replays every later minibatch, captures again after a PBT change of the hyperparameters, and the optimizer's
    step post-hook fires once a minibatch on both routes."""
    from sample_factory_tpu_torch.algo import learning
    from sample_factory_tpu_torch.algo.minibatch_graphs import MinibatchGraphs

    monkeypatch.setattr(MinibatchGraphs, "_capture", _replaying_capture)
    cfg, info, ts, traj = _invariants_setup(["--num_epochs=2"])
    runs = {}
    for graphed in (False, True):
        monkeypatch.setattr(learning, "replays_minibatches", lambda *a, graphed=graphed: graphed)
        run = copy.deepcopy(ts)
        train = make_train_fn(cfg, info)
        steps = []
        run.optimizer.register_step_post_hook(lambda opt, args, kwargs: steps.append(1))
        stats, counts = [], []
        for call in range(3):
            if call == 2:
                run.hparams["ppo_clip_ratio"] = 0.3  # as PBT changes it between train calls
            stats.append(train(run, traj, torch.Generator().manual_seed(call)))
            counts.append((train.graphs.captures, train.graphs.replays, len(steps)))
        runs[graphed] = run, stats, counts
    (eager, eager_stats, eager_counts), (graph, graph_stats, graph_counts) = runs[False], runs[True]
    assert eager_counts == [(0, 0, 4), (0, 0, 8), (0, 0, 12)]
    assert graph_counts == [(1, 3, 4), (1, 7, 8), (2, 10, 12)]
    for a, b in zip(eager_stats, graph_stats):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(eager.model.state_dict().values(), graph.model.state_dict().values()))
    for p, q in zip(eager.model.parameters(), graph.model.parameters()):
        m, n = eager.optimizer.state[p], graph.optimizer.state[q]
        assert torch.equal(m["exp_avg"], n["exp_avg"]) and torch.equal(m["exp_avg_sq"], n["exp_avg_sq"])


def _smoke_argv(train_dir, steps):
    return [
        "--env=grid_battle",
        "--device=cpu",
        "--async_rl=False",
        "--num_envs=8",
        "--rollout=8",
        "--batch_size=32",
        "--use_rnn=True",
        "--rnn_size=32",
        "--encoder_conv_architecture=convnet_impala",
        "--encoder_conv_mlp_layers", "32",
        "--compute_dtype=bfloat16",
        f"--train_for_env_steps={steps}",
        f"--train_dir={train_dir}",
        "--experiment=smoke",
        "--seed=1",
    ]


def test_run_rl_on_cpu_writes_checkpoint_and_resumes(tmp_path):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    exp = tmp_path / "smoke"
    profile_dir = tmp_path / "profile"
    _, runner = make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 128) + [f"--profiler_dir={profile_dir}"]))
    runner.init()
    assert runner.run() == 0
    # the profile leaves out the first 4 iterations: a 2-iteration run writes none (test_torch_tracing.py: the window)
    assert not (profile_dir / "trace.json").exists()
    assert runner.env_steps == 128  # 2 iterations of 8 envs x 8 steps
    stats = runner.host_stats()
    assert all(np.isfinite(v) for v in stats.values()) and stats["grad_norm"] > 0
    assert (exp / "config.json").is_file() and (exp / "done").read_text() == "128"
    ckpts = sorted((exp / "checkpoint_p0").glob("checkpoint_*.pth"))
    assert [c.name for c in ckpts] == ["checkpoint_000000000004_128.pth"]

    _, resumed = make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 192)))
    resumed.init()
    assert resumed.env_steps == 128 and resumed.train_state.train_step == 4
    torch.testing.assert_close(resumed.train_state.model.state_dict(), runner.train_state.model.state_dict())
    assert resumed.run() == 0
    assert resumed.env_steps == 192 and resumed.train_state.train_step == 6
    assert (exp / "done").read_text() == "192"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_unported_branches_raise(tmp_path, monkeypatch):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    # populations and multi-agent envs are ported: the population runner takes them
    for extra in (["--num_policies=2"], ["--env=grid_duel", "--encoder_conv_architecture=resnet_impala"]):
        _, runner = make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + extra))
        assert type(runner).__name__ == "MultiPolicyRunner"
    # host envs are ported too: a host env goes to the host runners (tests/test_torch_host_runner.py)
    from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole

    register_batched_cartpole("a_host_env")
    for extra, want in ((["--serial_mode=True"], "HostEnvRunner"), (["--serial_mode=True", "--num_policies=2"], "HostMultiPolicyRunner")):
        _, runner = make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + ["--env=a_host_env", "--use_rnn=False"] + extra))
        assert type(runner).__name__ == want
    # data and tensor parallelism on the device-env path are ported (tests/test_torch_multihost.py,
    # tests/test_torch_tensor_parallel.py); what cannot run is refused, never run on one device: a mesh
    # that does not cover the processes (a model axis of 2 on one process included), a run that asks
    # for a process group without the launcher's environment, and a launcher's world without the flag
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for extra, error, match in (
        (["--mesh_model=2"], ValueError, "mesh 0x2 does not cover 1 devices"),
        (["--mesh_data=4", "--mesh_model=2"], ValueError, "mesh 4x2 does not cover 1 devices"),
        (["--mesh_data=2"], ValueError, "mesh 2x1 does not cover 1 devices"),
        (["--jax_distributed=True"], RuntimeError, "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT not set"),
    ):
        with pytest.raises(error, match=match):
            make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + extra))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="without --jax_distributed=True each would train alone"):
        make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64)))
    # the host runners under a process group (A13b, tests/test_torch_multihost_hostenv.py) are ported; tensor
    # parallelism is refused there, as the JAX package shards nothing on them: a world of one, left before
    # the test ends
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    from sample_factory_tpu_torch.parallel.multihost import shutdown

    host_dp = _smoke_argv(tmp_path, 64) + ["--env=a_host_env", "--use_rnn=False", "--serial_mode=True", "--jax_distributed=True"]
    try:
        for extra, want in (([], "HostEnvRunner"), (["--num_policies=2"], "HostMultiPolicyRunner")):
            assert type(make_rl_runner(parse_custom_args(host_dp + extra))[1]).__name__ == want
        assert torch.distributed.is_initialized()
        with pytest.raises(NotImplementedError, match="HostEnvRunner does not shard parameters over the 'model' axis"):
            make_rl_runner(parse_custom_args(host_dp + ["--mesh_model=2"]))
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name)
    # all devices (-1, the default) and one device are the one device of a run without a group
    for extra in (["--mesh_data=-1"], ["--mesh_data=1", "--mesh_model=1"]):
        assert make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + extra))[1] is not None
    # wandb is ported (tests/test_torch_tooling.py): without the package it warns and trains
    assert make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + ["--with_wandb=True"]))[1] is not None
    # the default regime (async) is ported: no flag needed
    cfg, runner = make_rl_runner(parse_custom_args([a for a in _smoke_argv(tmp_path, 64) if a != "--async_rl=False"]))
    assert cfg.async_rl and runner is not None
    with pytest.raises(SystemExit):  # argparse refuses the JAX package's platform
        parse_custom_args(_smoke_argv(tmp_path, 64) + ["--device=tpu"])


IMPORT_EVERY_MODULE = (
    "import sys, tempfile, pkgutil, importlib\n"
    "import sample_factory_tpu_torch\n"
    "names = [m.name for m in pkgutil.walk_packages(sample_factory_tpu_torch.__path__, 'sample_factory_tpu_torch.')]\n"
    "assert {'sample_factory_tpu_torch.enjoy', 'sample_factory_tpu_torch.eval', 'sample_factory_tpu_torch.envs.builtin.ant',\n"
    "        'sample_factory_tpu_torch.runner.multi_policy_runner', 'sample_factory_tpu_torch.pbt.pbt',\n"
    "        'sample_factory_tpu_torch.algo.agent_policy_mapping', 'sample_factory_tpu_torch.algo.sampling_api',\n"
    "        'sample_factory_tpu_torch.envs.builtin.grid_duel', 'sample_factory_tpu_torch.native.shm_queue',\n"
    "        'sample_factory_tpu_torch.algo.host_worker', 'sample_factory_tpu_torch.algo.host_sampling',\n"
    "        'sample_factory_tpu_torch.algo.quantized_train', 'sample_factory_tpu_torch.runner.host_runner',\n"
    "        'sample_factory_tpu_torch.runner.host_multi_policy_runner', 'sample_factory_tpu_torch.envs.batched_host_env',\n"
    "        'sample_factory_tpu_torch.envs.gym_wrappers', 'sample_factory_tpu_torch.envs.gymnasium_compat',\n"
    "        'sample_factory_tpu_torch.envs.pettingzoo_adapter', 'sample_factory_tpu_torch.examples.train_gym_env',\n"
    "        'sample_factory_tpu_torch.examples.train_custom_multi_env', 'sample_factory_tpu_torch.utils.wandb_utils',\n"
    "        'sample_factory_tpu_torch.hub.huggingface_hub_utils', 'sample_factory_tpu_torch.launcher.run',\n"
    "        'sample_factory_tpu_torch.launcher.run_description', 'sample_factory_tpu_torch.launcher.run_processes',\n"
    "        'sample_factory_tpu_torch.launcher.run_slurm', 'sample_factory_tpu_torch.launcher.run_ngc',\n"
    "        'sample_factory_tpu_torch.export_model', 'sample_factory_tpu_torch.export_onnx',\n"
    "        'sample_factory_tpu_torch.onnx.onnx_pb2', 'sample_factory_tpu_torch.onnx.builder',\n"
    "        'sample_factory_tpu_torch.onnx.interp', 'sample_factory_tpu_torch.examples.export_gym_env',\n"
    "        'sample_factory_tpu_torch.examples.train_custom_env_custom_model', 'sample_factory_tpu_torch.examples.custom_encoders',\n"
    "        'sample_factory_tpu_torch.examples.enjoy_synthetic', 'sample_factory_tpu_torch.examples.enjoy_gym_env',\n"
    "        'sample_factory_tpu_torch.examples.sampler.use_simplified_sampling_api', 'sample_factory_tpu_torch.examples.train_pettingzoo_env',\n"
    "        'sample_factory_tpu_torch.examples.enjoy_pettingzoo_env', 'sample_factory_tpu_torch.examples.mujoco.mujoco_utils',\n"
    "        'sample_factory_tpu_torch.examples.mujoco.mujoco_params', 'sample_factory_tpu_torch.examples.mujoco.train_mujoco',\n"
    "        'sample_factory_tpu_torch.examples.mujoco.enjoy_mujoco', 'sample_factory_tpu_torch.examples.mujoco.fast_eval_mujoco',\n"
    "        'sample_factory_tpu_torch.examples.atari.atari_utils', 'sample_factory_tpu_torch.examples.atari.atari_params',\n"
    "        'sample_factory_tpu_torch.examples.atari.train_atari', 'sample_factory_tpu_torch.examples.envpool.envpool_utils',\n"
    "        'sample_factory_tpu_torch.examples.envpool.train_envpool_atari', 'sample_factory_tpu_torch.examples.vizdoom.doom_utils',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.doom.action_space', 'sample_factory_tpu_torch.examples.vizdoom.doom.wrappers',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.doom.doom_env', 'sample_factory_tpu_torch.examples.vizdoom.doom.multiplayer',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.doom.doom_render', 'sample_factory_tpu_torch.examples.vizdoom.doom.human_play',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.doom_params', 'sample_factory_tpu_torch.examples.vizdoom.train_vizdoom',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.enjoy_vizdoom', 'sample_factory_tpu_torch.examples.vizdoom.train_custom_vizdoom_env',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.enjoy_custom_vizdoom_env', 'sample_factory_tpu_torch.examples.vizdoom.play_doom',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.doom_play_demo', 'sample_factory_tpu_torch.examples.vizdoom.experiments.doom_basic_envs',\n"
    "        'sample_factory_tpu_torch.examples.vizdoom.experiments.doom_battle_appo', 'sample_factory_tpu_torch.examples.vizdoom.experiments.doom_duel_pbt',\n"
    "        'sample_factory_tpu_torch.examples.dmlab.dmlab30', 'sample_factory_tpu_torch.examples.dmlab.dmlab_level_cache',\n"
    "        'sample_factory_tpu_torch.examples.dmlab.dmlab_env', 'sample_factory_tpu_torch.examples.dmlab.dmlab_params',\n"
    "        'sample_factory_tpu_torch.examples.dmlab.dmlab_summaries', 'sample_factory_tpu_torch.examples.dmlab.train_dmlab',\n"
    "        'sample_factory_tpu_torch.examples.dmlab.enjoy_dmlab'} <= set(names)\n"
    "for name in names: importlib.import_module(name)\n"
    "import chip_smoke\n"
    "import bench_gpu\n"
)
REPORT_FOREIGN = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sample_factory_tpu', 'sf_examples_tpu'))\n"
    "print('FOREIGN', bad)\n"
)


def _fresh_interpreter(code):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_port_imports_no_jax():
    """Import every module of the port and train with it in a fresh interpreter, on a device env,
    a population, and host envs with worker processes (the batched cart-pole; the custom pixel env
    with its registered encoder): no JAX module loads."""
    code = IMPORT_EVERY_MODULE + (
        "from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components\n"
        "from sample_factory_tpu_torch.train import run_rl\n"
        "register_synthetic_components()\n"
        "d = tempfile.mkdtemp()\n"
        f"assert run_rl(parse_custom_args({_smoke_argv('TMP', 64)!r}[:-3] + ['--train_dir=' + d, '--experiment=e', '--seed=1'])) == 0\n"
        "from sample_factory_tpu_torch.export_model import export_model\n"
        "from sample_factory_tpu_torch.export_onnx import export_policy_onnx\n"
        "for export in (export_model, export_policy_onnx):\n"
        "    export(parse_custom_args(['--env=grid_battle', '--experiment=e', '--train_dir=' + d], evaluation=True))\n"
        f"assert run_rl(parse_custom_args({_smoke_argv('TMP', 64)!r}[:-3] + ['--train_dir=' + tempfile.mkdtemp(), '--experiment=p', '--seed=1',\n"
        "    '--num_policies=2', '--with_pbt=True', '--pbt_start_mutation=0', '--pbt_period_env_steps=16'])) == 0\n"
        "from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole\n"
        "register_batched_cartpole()\n"
        "assert run_rl(parse_custom_args(['--env=batched_cartpole', '--device=cpu', '--num_workers=2', '--num_envs_per_worker=4', '--rollout=8',\n"
        "    '--batch_size=32', '--train_for_env_steps=192', '--train_dir=' + tempfile.mkdtemp(), '--experiment=h', '--seed=1']),\n"
        "    register_fn=register_batched_cartpole) == 0\n"
        "from sample_factory_tpu_torch.examples import train_custom_env_custom_model as pixel\n"
        "pixel.register_custom_components()\n"
        "assert run_rl(pixel.parse_custom_args(['--env=my_custom_pixel_env', '--device=cpu', '--num_workers=2', '--num_envs_per_worker=4',\n"
        "    '--rollout=8', '--batch_size=32', '--train_for_env_steps=256', '--train_dir=' + tempfile.mkdtemp(), '--experiment=px', '--seed=1']),\n"
        "    register_fn=pixel.register_custom_components) == 0\n"
        "from sample_factory_tpu_torch import bridge\n"
        "assert bridge.unpack_msgpack(bytes([0x81, 0xa1, 0x61, 0x01])) == {'a': 1}\n"
        "assert bench_gpu.main([]) == 2\n"  # no card here: the benchmark refuses to run
    ) + REPORT_FOREIGN
    assert "FOREIGN []" in _fresh_interpreter(code)


def test_port_imports_and_trains_without_gymnasium():
    """The same imports with gymnasium made unimportable, as on a machine that lacks it: every
    module imports, and the host envs that declare their spaces in the port's own specs train:
    the 2-agent matching game with two policies, the batched cart-pole and the pixel env, and
    per-env envs: the doom_battle stand-in (tuple actions, GRU) and the DMLab example over the
    stand-in engine (instructions, LSTM), each with the random warm-up actions of the workers."""
    code = "import sys\nsys.modules['gymnasium'] = None\n" + IMPORT_EVERY_MODULE + (
        "from sample_factory_tpu_torch.train import run_rl\n"
        "from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole, register_bench_pixel\n"
        "from sample_factory_tpu_torch.examples import train_custom_multi_env as game\n"
        "from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args\n"
        "game.register_custom_components(); register_batched_cartpole(); register_bench_pixel()\n"
        "common = ['--device=cpu', '--serial_mode=True', '--num_workers=2', '--num_envs_per_worker=4', '--rollout=8', '--batch_size=32', '--seed=1']\n"
        "cfg = game.parse_custom_args(['--env=' + game.ENV_NAME, '--num_policies=2', '--train_for_env_steps=256',\n"
        "    '--train_dir=' + tempfile.mkdtemp(), '--experiment=g'] + common)\n"
        "assert run_rl(cfg, register_fn=game.register_custom_components) == 0\n"
        "for env in ('batched_cartpole', 'bench_host_pixel'):\n"
        "    cfg = parse_custom_args(['--env=' + env, '--train_for_env_steps=128', '--encoder_conv_mlp_layers', '32',\n"
        "        '--train_dir=' + tempfile.mkdtemp(), '--experiment=' + env] + common)\n"
        "    assert run_rl(cfg) == 0\n"
        "sys.path.insert(0, 'tests/standins')\n"
        "import doom_battle_standin\n"
        "from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg\n"
        "from sample_factory_tpu_torch.examples.dmlab import train_dmlab\n"
        "doom_battle_standin.register_doom_battle_standin()\n"
        "small = ['--train_for_env_steps=512', '--use_rnn=True', '--rnn_size=16', '--encoder_conv_mlp_layers', '16', '--train_dir=' + tempfile.mkdtemp()]\n"
        "cfg = parse_vizdoom_cfg(['--env=doom_battle', '--experiment=doom'] + common + small)\n"
        "assert run_rl(cfg, register_fn=doom_battle_standin.register_doom_battle_standin) == 0\n"
        "assert train_dmlab.main(['--env=dmlab_30', '--experiment=dmlab', '--rnn_size=16', '--recurrence=8', '--dmlab_level_cache_path=' + tempfile.mkdtemp()]\n"
        "    + common + small) == 0\n"
        "try:\n"
        "    import gymnasium\n"
        "    raise SystemExit('gymnasium imported')\n"
        "except ImportError:\n"
        "    pass\n"
    ) + REPORT_FOREIGN
    assert "FOREIGN []" in _fresh_interpreter(code)
