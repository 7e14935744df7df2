"""Tensor parallelism of the port over the 'model' mesh axis (`parallel/tensor_parallel.py`,
`parallel/mesh.py:shard_params_tp`): the counterparts of `tests/test_tensor_parallel.py`, with
gloo ranks on the CPU, small enough to run in tier-1.

A module fixture first runs the one-rank references of the runner cases in this process (no
group), then starts six processes once: four ranks of one group (world 4) and two of another
(world 2). Each runs `_child` and saves what it saw; the tests compare.

- World 4: the JAX test's configuration (an MLP 512-512 without RNN, 16 envs, rollout 8,
  `--tp_min_layer_width=256`; the observations are vectors, because the port refuses an 8x8
  image that its conv stack leaves without a pixel) through the runner for three iterations on
  a 2 x 2 mesh and on 4 x 1; and one train call on the 2 x 2 mesh that the JAX train call under
  `shard_params_tp` must equal.
- World 2 (a 1 x 2 mesh): one train call of a recurrent model (GRU with Adam, LSTM with LAMB
  and lookahead) whose conv, Dense and RNN leaves are all sharded, against one rank; the
  device-env runner in the sync regime (its clocks crossing `--train_for_seconds` on
  different iterations), its checkpoint, resume at `--mesh_model=2` from it and from a
  replicated checkpoint, the async regime, a run whose ranks act differently (it stops), and a run
  without --seed (the ranks take rank 0's).
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.env_info import EnvInfo
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.runner import AlgoObserver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 150
TP_TOL = 1e-6  # float32, a 1 x 2 mesh against one rank: the products split by columns, the sums in another order

# ------------------------------------------------------------------ the learner calls: an injected trajectory

T, N, NUM_ACTIONS = 8, 4, 6
LEARNER = {
    # the recurrent cases: convnet_impala (16 and 32 channels) + Dense 32 + an RNN of 32; at a width of 32
    # the second conv, the Dense and every leaf of the cell are sharded, the first conv and the heads not
    "gru_adam": (["--encoder_conv_architecture=convnet_impala", "--encoder_conv_mlp_layers", "32", "--rnn_size=32",
                  "--tp_min_layer_width=32", "--num_epochs=2"], (36, 36, 3), 32),
    "lstm_lamb": (["--encoder_conv_architecture=convnet_impala", "--encoder_conv_mlp_layers", "32", "--rnn_size=32",
                   "--rnn_type=lstm", "--tp_min_layer_width=32", "--optimizer=lamb", "--lamb_lookahead=True",
                   "--lamb_lookahead_k=1", "--shuffle_minibatches=True"], (36, 36, 3), 64),
    # against JAX under its shard_params_tp(..., 256): an MLP 256-256 and a GRU-128 (3H = 384)
    "jax": (["--encoder_mlp_layers", "256", "256", "--rnn_size=128", "--tp_min_layer_width=256"], (8,), 128),
}
LEARNER_COMMON = [f"--rollout={T}", f"--recurrence={T}", "--batch_size=16", f"--num_envs={N}", "--async_rl=False",
                  "--normalize_input=True", "--learning_rate=1e-4", "--seed=0"]


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _trajectory(obs_shape, rnn_width):
    """Time-major [T(+1), N, ...] from a seed."""
    rng = np.random.default_rng(0)
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    traj = {
        "obs": {"obs": rng.random((T + 1, N) + obs_shape).astype(np.float32)},
        "rnn_states": (rng.normal(size=(T + 1, N, rnn_width)) * 0.5).astype(np.float32),
        "actions": rng.integers(0, NUM_ACTIONS, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, NUM_ACTIONS)).astype(np.float32),
        "log_prob_actions": np.log(rng.uniform(0.1, 0.3, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "time_outs": dones * (rng.random((T, N)) < 0.5),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    return _map(traj, torch.tensor)


def _learner_setup(case, device_flag=("--device=cpu",)):
    extra, obs_shape, rnn_width = LEARNER[case]
    cfg = default_cfg(env="e", argv=LEARNER_COMMON + extra + list(device_flag))
    info = EnvInfo(obs_space=make_dict_spec({"obs": Box(obs_shape)}), action_space=Discrete(NUM_ACTIONS), num_agents=1,
                   is_device_env=True)
    model = create_actor_critic(cfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0))
    return cfg, info, init_train_state(cfg, info, model, "cpu"), _trajectory(obs_shape, rnn_width)


def _learner_call(case, mesh=None):
    """One train call; with `mesh`, sharded over its model axis, on the rows of this rank's data index.
    Returns the whole parameters and, under a mesh, this rank's own leaves and optimizer state."""
    from sample_factory_tpu_torch.parallel.mesh import shard_train_state
    from sample_factory_tpu_torch.runner.checkpoint import full_state_dict

    cfg, info, ts, traj = _learner_setup(case)
    if mesh is not None:
        shard_train_state(ts, mesh, cfg.tp_min_layer_width)
        per_rank = N // mesh.data
        traj = _map(traj, lambda x: x[:, mesh.data_index * per_rank : (mesh.data_index + 1) * per_rank])
    stats = make_train_fn(cfg, info, 0, mesh)(ts, traj, torch.Generator().manual_seed(1))
    out = {"params": {k: v.clone() for k, v in full_state_dict(ts)["model"].items()},
           "stats": {k: float(v) for k, v in stats.items()}, "train_step": ts.train_step}
    if mesh is not None:
        out["local"] = {k: v.clone() for k, v in ts.model.state_dict().items()}
        out["dims"] = dict(ts.tp.dims)
        names = [name for name, _ in ts.model.named_parameters()]
        out["optimizer"] = {names[i]: {k: tuple(v.shape) for k, v in s.items() if isinstance(v, torch.Tensor) and v.ndim}
                            for i, s in ts.optimizer.state_dict()["state"].items()}
    return out


# ------------------------------------------------------------------ the runner

QUIET = ["--save_every_sec=100000", "--save_best_every_sec=100000", "--experiment_summaries_interval=100000"]


def _jax_config_argv(train_dir, experiment, mesh_model):
    """`tests/test_tensor_parallel.py:21-37` on vector observations, 3 iterations of 16 envs x 8 steps."""
    return ["--env=synthetic_vector_discrete", "--custom_env_num_actions=4", "--use_rnn=False", "--encoder_mlp_layers",
            "512", "512", "--rollout=8", "--recurrence=1", "--batch_size=64", "--num_envs=16", f"--mesh_model={mesh_model}",
            "--tp_min_layer_width=256", "--num_epochs=1", "--seed=0", "--async_rl=False", "--device=cpu",
            "--train_for_env_steps=384", f"--train_dir={train_dir}", f"--experiment={experiment}", "--jax_distributed=True",
            *QUIET]


def _runner_argv(train_dir, steps, experiment, extra=()):
    """The device-env runner on the synthetic env with an MLP 16-16 and a GRU-16: 8 envs x 8 steps an
    iteration, 2 contiguous minibatches of 32. At a width of 16 both Dense layers and the GRU's leaves
    (3H = 48) are sharded over two ranks."""
    return ["--env=synthetic_vector_discrete", "--device=cpu", "--async_rl=False", "--num_envs=8", "--rollout=8",
            "--recurrence=8", "--batch_size=32", "--use_rnn=True", "--rnn_size=16", "--encoder_mlp_layers", "16", "16",
            "--normalize_input=True", "--tp_min_layer_width=16", f"--train_for_env_steps={steps}",
            f"--train_dir={train_dir}", f"--experiment={experiment}", "--seed=1", *QUIET, *extra]


TP = ["--jax_distributed=True", "--mesh_model=2"]
# continuous actions with the learned log-stddev vector, which is gathered where it is used: at a width of 2 it is
# sharded, and so is the action head (2 means), beside the MLP and the GRU
CONTINUOUS = ["--env=synthetic_continuous", "--adaptive_stddev=False", "--tp_min_layer_width=2"]


class _Record(AlgoObserver):
    """Every iteration's loss; `_run_runner` adds every rollout's trajectory and the collectives
    called inside the rollouts."""

    def __init__(self):
        self.losses, self.trajectories, self.rollout_collectives = [], [], 0

    def on_training_iteration(self, runner, stats):
        self.losses.append(float(stats["loss"]))


def _make_runner(argv, observers=()):
    """make_rl_runner -> init, its rollouts recorded; returns (runner, record)."""
    import torch.distributed as dist

    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    record = _Record()
    _, runner = make_rl_runner(parse_custom_args(argv))
    for observer in (record, *observers):
        runner.register_observer(observer)
    runner.init()
    rollout_fn = runner._rollout_fn

    def recording(*args):
        saved = {name: getattr(dist, name) for name in ("all_gather", "all_reduce", "broadcast")}

        def counted(fn):
            def call(*a, **k):
                record.rollout_collectives += 1
                return fn(*a, **k)

            return call

        for name, fn in saved.items():
            setattr(dist, name, counted(fn))
        try:
            out = rollout_fn(*args)
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
        record.trajectories.append(out[1])
        return out

    runner._rollout_fn = recording
    return runner, record


def _run_runner(argv, observers=()):
    """make_rl_runner -> init -> run; returns (runner, record)."""
    runner, record = _make_runner(argv, observers)
    assert runner.run() == 0
    return runner, record


def _full_params(runner):
    from sample_factory_tpu_torch.runner.checkpoint import full_state_dict

    return {k: v.clone() for k, v in full_state_dict(runner.train_state)["model"].items()}


def _episodes(runner):
    return {"total": runner.episode_stats.total_episodes, "rewards": list(runner.episode_stats.rewards),
            "lengths": list(runner.episode_stats.lengths)}


def _runner_result(runner, record):
    ts = runner.train_state
    names = [name for name, _ in ts.model.named_parameters()]
    return {"params": _full_params(runner), "local": {k: v.clone() for k, v in ts.model.state_dict().items()},
            "dims": dict(ts.tp.dims) if ts.tp is not None else {}, "losses": record.losses,
            "actions": [t["actions"] for t in record.trajectories], "rollout_collectives": record.rollout_collectives,
            "env_steps": runner.env_steps,
            "train_step": ts.train_step, "episodes": _episodes(runner),
            "optimizer": {names[i]: {k: tuple(v.shape) for k, v in s.items() if isinstance(v, torch.Tensor) and v.ndim}
                          for i, s in ts.optimizer.state_dict()["state"].items()},
            "shard": None if runner.sampler_state.shard is None else (runner.sampler_state.shard.start, runner.sampler_state.shard.stop)}


# ------------------------------------------------------------------ the child processes


def _world4(rank, train_dir):
    from sample_factory_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for name, mesh_model in (("tp", 2), ("dp", 1)):
        runner, record = _run_runner(_jax_config_argv(train_dir, name, mesh_model))
        out[name] = {**_runner_result(runner, record), "mesh": (runner.mesh.data_index, runner.mesh.model_index)}
    mesh = make_mesh(default_cfg(env="e", argv=["--device=cpu", "--mesh_model=2"]))
    out["jax_learner"] = _learner_call("jax", mesh)
    return out


def _world2(rank, train_dir, one_dir):
    from sample_factory_tpu_torch.parallel.mesh import make_mesh
    from sample_factory_tpu_torch.parallel.multihost import sync_barrier

    mesh = make_mesh(default_cfg(env="e", argv=["--device=cpu", "--mesh_model=2"]))
    out = {"learner": {case: _learner_call(case, mesh) for case in ("gru_adam", "lstm_lamb")}}

    class ClockJump(AlgoObserver):
        """Rank 1's clock says a checkpoint is due after its first iteration (a save gathers: rank 0 must
        join it) and crosses --train_for_seconds after its second; rank 0's clock does neither."""

        def __init__(self):
            self.iterations = 0

        def on_training_iteration(self, runner, stats):
            self.iterations += 1
            if rank == 1 and self.iterations == 1:
                runner._last_checkpoint -= 1e6
            if rank == 1 and self.iterations == 2:
                runner._start_time -= 1e6

    clock = ClockJump()
    runner, record = _run_runner(_runner_argv(train_dir, 320, "tp", TP + ["--train_for_seconds=3600"]), [clock])
    out["sync"] = {**_runner_result(runner, record), "iterations": clock.iterations}
    sync_barrier()  # rank 0's final checkpoint is on disk
    ckpt_dir = os.path.join(train_dir, "tp", "checkpoint_p0")
    out["checkpoints"] = sorted(os.listdir(ckpt_dir))

    # resume under tensor parallelism from its own checkpoint, and from a replicated one (a run without a group)
    if rank == 0:
        shutil.copytree(os.path.join(one_dir, "one_sync"), os.path.join(train_dir, "from_one"))
    sync_barrier()
    for name in ("tp", "from_one"):
        runner, record = _run_runner(_runner_argv(train_dir, 256, name, TP))
        out[f"resume_{name}"] = {**_runner_result(runner, record), "first_loss": record.losses[0]}

    runner, record = _run_runner(_runner_argv(train_dir, 128, "tp_async", TP + ["--async_rl=True"]))
    out["async"] = _runner_result(runner, record)
    runner, record = _run_runner(_runner_argv(train_dir, 64, "tp_continuous", TP + CONTINUOUS))
    out["continuous"] = _runner_result(runner, record)
    out["split"] = _split_actions(rank, train_dir)
    out["unseeded"] = _unseeded(train_dir)
    return out


def _unseeded(train_dir):
    """No --seed: each process draws its own from the OS, and the runner must take rank 0's, or the
    model group's ranks would draw different actions. Returns (the seed, the error or None)."""
    argv = [a for a in _runner_argv(train_dir, 128, "tp_unseeded", TP) if not a.startswith("--seed")]
    runner, _ = _make_runner(argv)
    try:
        runner.run()
    except RuntimeError as e:
        return runner.cfg.seed, str(e)
    return runner.cfg.seed, None


def _split_actions(rank, train_dir):
    """Rank 1 alone changes one action of its first rollout: both ranks must stop after that
    iteration with the same error. Returns (the error, the rollouts each ran)."""
    runner, record = _make_runner(_runner_argv(train_dir, 192, "tp_split", TP))
    rollout_fn, num_actions = runner._rollout_fn, runner.env_info.action_space.n

    def split(*args):
        ss, traj, ep_stats = rollout_fn(*args)
        if rank == 1 and len(record.trajectories) == 1:
            actions = traj["actions"].clone()
            actions.view(-1)[5] = (actions.view(-1)[5] + 1) % num_actions
            traj = {**traj, "actions": actions}
        return ss, traj, ep_stats

    runner._rollout_fn = split
    try:
        runner.run()
    except RuntimeError as e:
        return str(e), len(record.trajectories)
    return None, len(record.trajectories)


def _child(out_dir, rank, world, port, one_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from sample_factory_tpu_torch.parallel import multihost

    multihost.init_distributed(backend="gloo")
    train_dir = os.path.join(out_dir, f"train_w{world}")
    try:
        out = _world4(rank, train_dir) if world == 4 else _world2(rank, train_dir, one_dir)
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(out_dir, f"w{world}_rank{rank}.pt"))


# ------------------------------------------------------------------ fixture


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The one-rank references, then the six ranks; {"one": ..., (world, rank): what each saved}."""
    one_dir = tmp_path_factory.mktemp("one")
    runner, record = _run_runner(_runner_argv(one_dir, 192, "one_sync"))
    one = {"sync": _runner_result(runner, record)}
    runner, record = _run_runner(_runner_argv(one_dir, 128, "one_async", ["--async_rl=True"]))
    one["async"] = _runner_result(runner, record)
    runner, record = _run_runner(_runner_argv(one_dir, 64, "one_continuous", CONTINUOUS))
    one["continuous"] = _runner_result(runner, record)

    out_dir = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    ports = {4: _free_port(), 2: _free_port()}
    procs = {}
    for world, rank in [(4, r) for r in range(4)] + [(2, r) for r in range(2)]:
        code = (f"import sys; sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_tensor_parallel as t; "
                f"t._child({str(out_dir)!r}, {rank}, {world}, {ports[world]}, {str(one_dir)!r})")
        log = open(out_dir / f"w{world}_rank{rank}.log", "w")
        procs[(world, rank)] = (subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=log,
                                                 stderr=subprocess.STDOUT), log)
    try:
        for key, (proc, log) in procs.items():
            proc.wait(timeout=CHILD_TIMEOUT_S)
            log.close()
            text = (out_dir / f"w{key[0]}_rank{key[1]}.log").read_text()
            assert proc.returncode == 0, f"world {key[0]} rank {key[1]} failed:\n{text[-4000:]}"
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = {key: torch.load(out_dir / f"w{key[0]}_rank{key[1]}.pt", weights_only=False) for key in procs}
    return {"one": one, "one_dir": str(one_dir), "train_dir": str(out_dir / "train_w2"), **results}


def _ranks(tp, world):
    return [tp[(world, r)] for r in range(world)]


def _close(got, want, tol, what=""):
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=tol, rtol=0, err_msg=f"{what}{name}")


def _check_shards(result, world_model=2):
    """Each sharded leaf and its optimizer state hold exactly 1/M of the whole along the split dim."""
    assert result["dims"], "nothing was sharded"
    for name, dim in result["dims"].items():
        full, local = result["params"][name].shape, result["local"][name].shape
        want = full[:dim] + (full[dim] // world_model,) + full[dim + 1 :]
        assert local == want, (name, local, full)
        for key, shape in result["optimizer"].get(name, {}).items():
            assert shape == want, (name, key, shape)
    for name, value in result["local"].items():
        if name not in result["dims"]:
            assert value.shape == result["params"][name].shape, name


def _replicated_identical(results):
    first = results[0]
    for r in results[1:]:
        for name, value in first["local"].items():
            if name not in first["dims"]:
                assert torch.equal(value, r["local"][name]), name


# ------------------------------------------------------------------ 2 x 2 = 4 x 1 (the JAX test's configuration)


def test_two_by_two_equals_four_by_one(tp):
    """The JAX test's tolerance on the losses of three iterations; the port holds the parameters to 1e-5."""
    ranks = _ranks(tp, 4)
    dp, tp2 = ranks[0]["dp"], ranks[0]["tp"]
    assert [r["tp"]["mesh"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["tp"]["shard"] for r in ranks] == [(0, 8), (0, 8), (8, 16), (8, 16)]  # by data index
    assert [r["dp"]["shard"] for r in ranks] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert len(tp2["losses"]) == len(dp["losses"]) == 3 and all(np.isfinite(tp2["losses"]))
    np.testing.assert_allclose(tp2["losses"], dp["losses"], rtol=2e-3, atol=2e-4)
    _close(tp2["params"], dp["params"], 1e-5)
    assert set(tp2["dims"]) == {"encoder.encoders.enc_obs.dense.0.weight", "encoder.encoders.enc_obs.dense.0.bias",
                                "encoder.encoders.enc_obs.dense.1.weight", "encoder.encoders.enc_obs.dense.1.bias"}
    for r in ranks:
        _check_shards(r["tp"])
        assert r["tp"]["episodes"]["total"] == dp["episodes"]["total"] == 16  # not 32
        np.testing.assert_allclose(r["tp"]["episodes"]["rewards"], dp["episodes"]["rewards"], rtol=1e-5)
        assert all(torch.equal(a, b) for a, b in zip(r["tp"]["params"].values(), tp2["params"].values()))
    _replicated_identical([r["tp"] for r in ranks])


def test_train_call_equals_jax_under_shard_params_tp(tp):
    """The JAX train call on a (2, 2) mesh of the tests' virtual devices, its train state placed by
    `shard_params_tp(..., 256)`, from the same parameters on the same trajectory: the 2 x 2 ranks'
    gathered parameters to 1e-5."""
    import jax
    import jax.numpy as jnp

    from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
    from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn
    from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
    from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
    from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo
    from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
    from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
    from sample_factory_tpu.parallel.mesh import make_mesh as jax_make_mesh, shard_params_tp as jax_shard_params_tp
    from sample_factory_tpu_torch import bridge

    assert len(jax.devices()) >= 4
    extra, obs_shape, _ = LEARNER["jax"]
    _, _, ts, traj = _learner_setup("jax")
    jcfg = jax_default_cfg(env="e", argv=LEARNER_COMMON + extra + ["--mesh_data=2", "--mesh_model=2"])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox(obs_shape)}), action_space=JDiscrete(NUM_ACTIONS), num_agents=1,
                       is_device_env=True)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2,) + obs_shape)})
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(ts.model.state_dict(), ts.model))
    jts = jts.replace(params=params, opt_state=tx.init(params))
    mesh = jax_make_mesh(jcfg, devices=jax.devices()[:4])
    jts = jax_shard_params_tp(jts, mesh, jcfg.tp_min_layer_width)
    assert any(len(leaf.sharding.device_set) == 4 and not leaf.sharding.is_fully_replicated for leaf in jax.tree.leaves(jts.params))
    jts2, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, _map(traj, lambda x: jnp.asarray(x.numpy())), jax.random.PRNGKey(1))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), ts.model)
    ranks = [r["jax_learner"] for r in _ranks(tp, 4)]
    assert set(ranks[0]["dims"]) >= {"core.gru_0.wi", "core.gru_0.wh", "core.gru_0.bi", "core.gru_0.bh"}
    for r in ranks:
        _close(r["params"], want, 1e-5, "jax: ")
        _check_shards(r)


# ------------------------------------------------------------------ 1 x 2 = one rank


@pytest.mark.parametrize("case", ["gru_adam", "lstm_lamb"])
def test_one_by_two_equals_one_rank_after_a_train_call(tp, case):
    want = _learner_call(case)
    ranks = [r["learner"][case] for r in _ranks(tp, 2)]
    cell = "lstm_0" if case == "lstm_lamb" else "gru_0"
    leaves = ("wi", "wh", "bi") + (() if case == "lstm_lamb" else ("bh",))
    assert set(ranks[0]["dims"]) == {f"core.{cell}.{leaf}" for leaf in leaves} | {
        f"encoder.encoders.enc_obs.{layer}.{p}" for layer in ("conv.1", "dense.0") for p in ("weight", "bias")}
    for r in ranks:
        _close(r["params"], want["params"], TP_TOL)
        assert r["train_step"] == want["train_step"]
        for key in ("loss", "policy_loss", "value_loss", "grad_norm", "adv_mean", "adv_std", "valids_fraction"):
            np.testing.assert_allclose(r["stats"][key], want["stats"][key], atol=1e-5, rtol=1e-5, err_msg=key)
        _check_shards(r)
    _replicated_identical(ranks)


def test_one_by_two_runner_equals_one_rank(tp):
    """The sync regime for three iterations: the actions of every rollout equal one rank's exactly,
    the rollouts make no collective (they act with the whole parameters, gathered before each), the
    parameters within TP_TOL, the episode sums one rank's (not doubled), and the stop agreed: rank
    1's clock crossed --train_for_seconds after its second iteration, so both ran a third and no
    fourth, short of the five that --train_for_env_steps allows."""
    want = tp["one"]["sync"]
    ranks = [r["sync"] for r in _ranks(tp, 2)]
    for r in ranks:
        assert r["iterations"] == 3 and r["env_steps"] == 192 and r["shard"] == (0, 8)
        assert all(torch.equal(a, b) for a, b in zip(r["actions"], want["actions"])) and len(r["actions"]) == 3
        assert r["rollout_collectives"] == 0
        _close(r["params"], want["params"], TP_TOL)
        assert r["episodes"] == want["episodes"] and want["episodes"]["total"] == 8
        _check_shards(r)
    _replicated_identical(ranks)


def test_one_by_two_async_equals_one_rank(tp):
    want = tp["one"]["async"]
    for r in (r["async"] for r in _ranks(tp, 2)):
        assert r["env_steps"] == 128 and r["train_step"] == want["train_step"]
        assert all(torch.equal(a, b) for a, b in zip(r["actions"], want["actions"])) and len(r["actions"]) == 2
        assert r["rollout_collectives"] == 0
        _close(r["params"], want["params"], TP_TOL)
        _check_shards(r)


def test_ranks_that_act_differently_stop_the_run(tp):
    """One action of rank 1's first rollout changed: the checksums in the iteration's all-reduce
    differ, and both ranks raise after that iteration, not later and not one of them alone."""
    for message, rollouts in (r["split"] for r in _ranks(tp, 2)):
        assert message is not None and "model group 0 (ranks 0-1) sampled different actions" in message
        assert rollouts == 1


def test_one_by_two_continuous_gathers_the_learned_stddev(tp):
    want = tp["one"]["continuous"]
    for r in (r["continuous"] for r in _ranks(tp, 2)):
        assert {"action_parameterization.learned_stddev", "action_parameterization.distribution_linear.weight"} <= set(r["dims"])
        assert r["env_steps"] == 64 and r["train_step"] == want["train_step"]
        for a, b in zip(r["actions"], want["actions"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
        _close(r["params"], want["params"], TP_TOL)
        _check_shards(r)


# ------------------------------------------------------------------ checkpoints


def test_checkpoint_is_the_gathered_state_and_resumes_at_either_width(tp):
    """The 1 x 2 run's checkpoints (rank 0 alone writes them): one after the second iteration, which rank
    1's clock alone called for (its observer moved the clock after the first) and both ranks gathered,
    and the final one. The final one holds the whole
    state: it equals the ranks' gathered parameters, and the run resumes from it at --mesh_model=2 and at
    --mesh_model=1 (here, without a group)."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    r0, r1 = _ranks(tp, 2)
    assert r0["checkpoints"] == r1["checkpoints"] == ["checkpoint_000000000004_128.pth", "checkpoint_000000000006_192.pth"]
    path = os.path.join(tp["train_dir"], "tp", "checkpoint_p0", r0["checkpoints"][-1])
    saved = torch.load(path, weights_only=True)["train_state"]
    for name, value in r0["sync"]["params"].items():
        assert torch.equal(saved["model"][name], value), name
    adam = saved["optimizer"]["state"]
    assert all(v["exp_avg"].shape == p.shape for v, p in zip(adam.values(), saved["model"].values()))

    for r in (r0, r1):
        resumed = r["resume_tp"]
        assert resumed["env_steps"] == 256 and resumed["train_step"] == 8
        _check_shards(resumed)
    # at --mesh_model=1: the file read whole into one rank's train state
    register_synthetic_components()
    work = os.path.join(tp["train_dir"], "..", "resume_one")
    shutil.copytree(os.path.join(tp["train_dir"], "tp"), os.path.join(work, "tp"), dirs_exist_ok=True)
    for name in os.listdir(os.path.join(work, "tp", "checkpoint_p0")):
        if name != r0["checkpoints"][-1]:
            os.remove(os.path.join(work, "tp", "checkpoint_p0", name))
    _, one = make_rl_runner(parse_custom_args(_runner_argv(work, 256, "tp", ["--jax_distributed=False", "--mesh_model=1"])))
    one.init()
    assert one.env_steps == 192 and one.train_state.train_step == 6 and one.train_state.tp is None
    for name, value in one.train_state.model.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name
    for i, state in one.train_state.optimizer.state_dict()["state"].items():
        assert torch.equal(state["exp_avg"], adam[i]["exp_avg"]) and torch.equal(state["exp_avg_sq"], adam[i]["exp_avg_sq"])


def test_replicated_checkpoint_resumes_under_tensor_parallelism(tp):
    """The one-rank run's checkpoint resumes on a 1 x 2 mesh: each rank starts from its shards of the
    file (step 6, 192 env steps), trains one more iteration, and the replicas agree."""
    ranks = [r["resume_from_one"] for r in _ranks(tp, 2)]
    for r in ranks:
        assert r["env_steps"] == 256 and r["train_step"] == 8 and np.isfinite(r["first_loss"])
        _check_shards(r)
    assert all(torch.equal(v, ranks[1]["params"][k]) for k, v in ranks[0]["params"].items())
    _replicated_identical(ranks)


def test_loads_keep_this_ranks_shards(tmp_path):
    """Loading into a sharded train state reads the whole file and keeps the rank's shards: a
    checkpoint of the port (parameters and Adam's moments) and a `.msgpack` of the JAX package (its
    parameters), on either model index. Slicing needs no collective: no group here."""
    import glob

    from sample_factory_tpu.algo.context import reset_global_context
    from sample_factory_tpu.train import run_rl as jax_run_rl
    from sf_examples_tpu.train_synthetic import parse_custom_args as jax_parse_custom_args
    from sf_examples_tpu.train_synthetic import register_synthetic_components as jax_register_synthetic_components
    from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
    from sample_factory_tpu_torch.envs.env_info import obtain_env_info
    from sample_factory_tpu_torch.envs.env_utils import create_env
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.parallel.mesh import Mesh, shard_train_state
    from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint, restore_from_jax_checkpoint, save_checkpoint

    argv = ["--env=synthetic_vector_discrete", "--use_rnn=True", "--rnn_size=16", "--recurrence=8", "--encoder_mlp_layers", "32",
            "--experiment=run", f"--train_dir={tmp_path}", "--seed=2", "--device=cpu", "--num_workers=1", "--num_envs_per_worker=8",
            "--rollout=8", "--batch_size=64", "--train_for_env_steps=640", "--tp_min_layer_width=32"]
    reset_global_context()
    jax_register_synthetic_components()
    assert jax_run_rl(jax_parse_custom_args(argv)) == 0
    reset_global_context()
    (jax_path,) = glob.glob(os.path.join(str(tmp_path), "run", "checkpoint_p0", "checkpoint_*.msgpack"))
    register_synthetic_components()
    cfg = parse_custom_args(argv + ["--experiment=port"])
    info = obtain_env_info(cfg)

    def train_state():
        return init_train_state(cfg, info, create_actor_critic(cfg, info.obs_space, info.action_space, torch.Generator().manual_seed(3)), "cpu")

    whole = train_state()
    restore_from_jax_checkpoint(whole, jax_path)
    jax_params = {k: v.clone() for k, v in whole.model.state_dict().items()}
    own = train_state()  # a rollout and a train call give Adam its moments
    env = create_env(cfg.env, cfg=cfg)
    _, traj, _ = make_rollout_fn(cfg, env, info)(own.model, own.obs_rms, init_sampler_state(cfg, env, 8, "cpu", torch.Generator().manual_seed(0)), 0, 0)
    make_train_fn(cfg, info)(own, traj, torch.Generator().manual_seed(1))
    save_checkpoint(cfg, 0, own, 64, 0.5)
    names = [n for n, _ in own.model.named_parameters()]
    adam = own.optimizer.state_dict()["state"]
    for index in (0, 1):
        mesh = Mesh(world=2, rank=index, data=1, model=2, device=torch.device("cpu"), distributed=True)
        for load, want, moments in ((lambda ts: restore_from_jax_checkpoint(ts, jax_path), jax_params, None),
                                    (lambda ts: load_checkpoint(cfg, 0, ts), own.model.state_dict(), adam)):
            sharded = train_state()
            shard_train_state(sharded, mesh, cfg.tp_min_layer_width)
            assert set(sharded.tp.dims) >= {"core.gru_0.wi", "core.gru_0.wh", "encoder.encoders.enc_obs.dense.0.weight"}
            load(sharded)
            for name, value in sharded.model.state_dict().items():
                dim = sharded.tp.dims.get(name)
                assert torch.equal(value, want[name] if dim is None else mesh.model_axis.own(want[name], dim)), name
            for i, state in (sharded.optimizer.state_dict()["state"].items() if moments else ()):
                dim = sharded.tp.dims.get(names[i])
                full = moments[i]["exp_avg"]
                assert torch.equal(state["exp_avg"], full if dim is None else mesh.model_axis.own(full, dim)), names[i]


# ------------------------------------------------------------------ the layout and the refusals


def test_shard_params_tp_takes_the_flax_width():
    """A Dense's width is its output features (dim 0 of the torch weight [out, in]), not the input
    dim that a naive "last dim" would take; a conv's is its output channels; a cell's leaves keep
    the flax layout. Nothing is sliced without a model axis."""
    from sample_factory_tpu_torch.models.model_utils import Conv, Dense, init_parameters_
    from sample_factory_tpu_torch.ops.rnn_cells import FusedGRUCell
    from sample_factory_tpu_torch.parallel.mesh import Mesh, shard_params_tp
    from sample_factory_tpu_torch.parallel.tensor_parallel import flax_width_dim

    dense, conv, cell = Dense(64, 8), Conv(3, 32, 3, 1), FusedGRUCell(8, 16)
    assert flax_width_dim(dense, "weight", dense.weight) == 0 and flax_width_dim(dense, "bias", dense.bias) == 0
    assert flax_width_dim(conv, "weight", conv.weight) == 0
    assert flax_width_dim(cell, "wi", cell.wi) == 1 and flax_width_dim(cell, "wh", cell.wh) == 1
    model = init_parameters_(torch.nn.Sequential(dense, conv, cell), torch.Generator().manual_seed(0))
    one = Mesh(world=1, rank=0, data=1, model=1, device=torch.device("cpu"), distributed=False)
    assert shard_params_tp(model, one, 1) is None and dense.weight.shape == (8, 64)
    two = Mesh(world=2, rank=1, data=1, model=2, device=torch.device("cpu"), distributed=True)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    layout = shard_params_tp(model, two, 16)  # Dense [8, 64]: 8 outputs, replicated though its input is 64 wide
    assert layout.dims == {"1.weight": 0, "1.bias": 0, "2.wi": 1, "2.wh": 1, "2.bi": 0, "2.bh": 0}
    assert dense.model_axis is None and conv.model_axis.index == 1 and cell.tp_dims == {"wi": 1, "wh": 1, "bi": 0, "bh": 0}
    assert torch.equal(model.state_dict()["1.weight"], full["1.weight"][16:]) and torch.equal(model.state_dict()["2.wh"], full["2.wh"][:, 24:])


def test_ranks_without_a_seed_take_rank_0s(tp):
    """Without --seed the ranks agree on rank 0's seed and the run completes, its model group acting alike."""
    (seed0, error0), (seed1, error1) = (r["unseeded"] for r in _ranks(tp, 2))
    assert error0 is None and error1 is None
    assert seed0 == seed1


def test_replicate_tree_refuses_a_sharded_state():
    """Replication comes first and sharding after it (`Runner.init`): a sharded state is refused,
    before any collective."""
    from sample_factory_tpu_torch.parallel.mesh import Mesh, replicate_tree, shard_train_state

    _, _, ts, _ = _learner_setup("gru_adam")
    mesh = Mesh(world=2, rank=1, data=1, model=2, device=torch.device("cpu"), distributed=True)
    shard_train_state(ts, mesh, 32)
    assert ts.tp is not None
    with pytest.raises(ValueError, match="shard it after replicating it"):
        replicate_tree(ts, mesh)


def test_host_and_population_runners_refuse_tensor_parallelism(tmp_path):
    from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    register_batched_cartpole("a_tp_host_env")
    base = _runner_argv(tmp_path, 64, "refused", ["--mesh_model=2"])
    for extra, name in ((["--env=a_tp_host_env", "--use_rnn=False", "--serial_mode=True"], "HostEnvRunner"),
                        (["--env=a_tp_host_env", "--use_rnn=False", "--serial_mode=True", "--num_policies=2"], "HostMultiPolicyRunner"),
                        (["--num_policies=2"], "MultiPolicyRunner")):
        with pytest.raises(NotImplementedError, match=f"{name} does not shard parameters .* as the JAX package's does not"):
            make_rl_runner(parse_custom_args(base + extra))
