"""Data parallelism of the port on torch.distributed (`parallel/mesh.py`,
`parallel/multihost.py`): the counterparts of `tests/test_multihost.py`, with two gloo
ranks on the CPU, small enough to run in tier-1.

A module fixture starts three processes once: two ranks of one group (world 2) and one
rank alone in another (world 1). Each runs `_child` and saves what it saw. The two ranks
check the multihost helpers, PBT with and without the objectives' broadcast and the
writer's gating; then one learner call in four configurations on its
half of the envs; then a data-parallel run of the device-env `Runner` whose clocks cross
`--train_for_seconds` on different iterations, and its resume. This process computes the
one-rank references without a group and compares:

- 2 ranks x N/2 envs equal 1 rank x N envs, parameter for parameter, to 1e-5 (float32)
  after one train call: sync GAE with two contiguous minibatches (the first lies wholly
  on rank 0), shuffled minibatches with the symmetric-KL loss, V-trace with lagged steps
  (the ranks' valid counts differ), and returns normalization; one of them against the
  JAX train call too;
- the runner's rollout rows equal the one-rank rollout's exactly (an MLP model, whose
  products give the same bits at either batch size on the CPU);
- the replicas are identical after three iterations, and the ranks stop together;
- only rank 0 writes a checkpoint, and both resume from it, also where rank 1's train_dir
  holds none (it takes rank 0's state and env steps);
- a world of one equals the run without a group bit for bit, and without a group a
  train call makes no `torch.distributed` call.
"""

import os
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

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
T, N, RNN, OBS = 8, 4, 32, (36, 36, 3)

LEARNER_ARGV = [
    "--encoder_conv_architecture=convnet_impala", "--encoder_conv_mlp_layers", "32", f"--rnn_size={RNN}",
    f"--rollout={T}", f"--recurrence={T}", "--batch_size=16", f"--num_envs={N}", "--async_rl=False",
    "--normalize_input=True", "--normalize_returns=False", "--learning_rate=1e-4", "--seed=0", "--device=cpu",
]
# N * T = 32 rows in minibatches of 16: with two ranks, contiguous minibatch 0 lies wholly on rank 0
LEARNER_CASES = {
    "gae_contiguous": ["--num_epochs=2"],
    "shuffled_symmetric_kl": ["--shuffle_minibatches=True", "--num_epochs=2", "--exploration_loss=symmetric_kl"],
    "vtrace_lagged": ["--with_vtrace=True", "--vtrace_rho=0.9", "--vtrace_c=1.1", "--max_policy_lag=5"],
    "normalize_returns": ["--normalize_returns=True"],
}
LAGGED_TRAIN_STEP = 10


# ------------------------------------------------------------------ shared by the children and the tests


def _trajectory(lagged: bool):
    """Time-major [T(+1), N, ...] from a seed. Env 1's last steps come from another policy;
    with `lagged`, env 2 was collected 7 versions ago and env 3's first steps 5 ago, so that
    at train step 10 with --max_policy_lag=5 they are invalid: rank 1 (envs 2, 3) holds fewer
    valid steps than rank 0."""
    rng = np.random.default_rng(0)
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    versions = np.full((T, N), 8 if lagged else 0, np.int32)
    if lagged:
        versions[:, 2] = 3
        versions[:3, 3] = 5
    traj = {
        "obs": {"obs": rng.random((T + 1, N) + OBS).astype(np.float32)},
        "rnn_states": (rng.normal(size=(T + 1, N, RNN)) * 0.5).astype(np.float32),
        "actions": rng.integers(0, 6, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, 6)).astype(np.float32),
        "log_prob_actions": np.log(rng.uniform(0.1, 0.3, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "time_outs": dones * (rng.random((T, N)) < 0.5),
        "policy_version": versions,
        "policy_id": np.where((np.arange(N)[None] == 1) & (np.arange(T)[:, None] >= 5), 1, 0).astype(np.int32),
    }
    return _map(traj, torch.tensor)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _learner_setup(case):
    cfg = default_cfg(env="e", argv=LEARNER_ARGV + LEARNER_CASES[case])
    info = EnvInfo(obs_space=make_dict_spec({"obs": Box(OBS)}), action_space=Discrete(6), num_agents=1, is_device_env=True)
    model = create_actor_critic(cfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0))
    ts = init_train_state(cfg, info, model, "cpu")
    lagged = case == "vtrace_lagged"
    if lagged:
        ts.train_step = LAGGED_TRAIN_STEP
    return cfg, info, ts, _trajectory(lagged)


def _learner_result(ts, stats):
    return {
        "params": {k: v.clone() for k, v in ts.model.state_dict().items()},
        "obs_rms": ts.obs_rms["obs"].state_dict(),
        "returns_rms": None if ts.returns_rms is None else ts.returns_rms.state_dict(),
        "train_step": ts.train_step,
        "curr_lr": ts.curr_lr,
        "stats": {k: float(v) for k, v in stats.items()},
    }


def _learner_call(case, mesh=None):
    """One train call; with `mesh`, on this rank's half of the envs."""
    cfg, info, ts, traj = _learner_setup(case)
    if mesh is not None:
        per_rank = N // mesh.data
        traj = _map(traj, lambda x: x[:, mesh.rank * per_rank : (mesh.rank + 1) * per_rank])
    stats = make_train_fn(cfg, info, 0, mesh)(ts, traj, torch.Generator().manual_seed(1))
    return _learner_result(ts, stats)


def _runner_argv(train_dir, steps, experiment, extra=()):
    """The device-env runner on the synthetic env with an MLP + GRU-16: 8 envs x 8 steps an
    iteration, 2 contiguous minibatches of 32."""
    return [
        "--env=synthetic_vector_discrete", "--device=cpu", "--async_rl=False", "--num_envs=8", "--rollout=8",
        "--recurrence=8", "--batch_size=32", "--use_rnn=True", "--rnn_size=16", "--encoder_mlp_layers", "16", "16",
        "--normalize_input=True", f"--train_for_env_steps={steps}", f"--train_dir={train_dir}", f"--experiment={experiment}",
        "--seed=1", "--save_every_sec=100000", "--save_best_every_sec=100000", "--experiment_summaries_interval=100000",
        *extra,
    ]


def _run_runner(argv, observers=()):
    """make_rl_runner -> init -> run, recording every rollout's trajectory."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    _, runner = make_rl_runner(parse_custom_args(argv))
    for observer in observers:
        runner.register_observer(observer)
    runner.init()
    trajectories = []
    rollout_fn = runner._rollout_fn

    def recording(*args):
        out = rollout_fn(*args)
        trajectories.append(out[1])
        return out

    runner._rollout_fn = recording
    assert runner.run() == 0
    return runner, trajectories


def _params(runner):
    return {k: v.clone() for k, v in runner.train_state.model.state_dict().items()}


# ------------------------------------------------------------------ the child processes


def _helper_cases(rank, train_dir):
    import copy

    from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticVectorDiscreteEnv
    from sample_factory_tpu_torch.envs.env_info import extract_env_info
    from sample_factory_tpu_torch.parallel.multihost import (
        broadcast_from_primary,
        broadcast_objectives,
        is_primary_host,
        sync_barrier,
    )
    from sample_factory_tpu_torch.pbt.pbt import PopulationBasedTraining
    from sample_factory_tpu_torch.runner.stats import SummaryWriter

    out = {"primary": is_primary_host()}
    out["bcast"] = np.asarray(broadcast_from_primary(np.asarray([rank * 100 + 7], np.int32))).tolist()

    # PBT: objectives that rank each rank's population differently
    P = 4
    cfg = default_cfg(env="synthetic_vector_discrete", argv=[
        "--encoder_mlp_layers", "16", "16", "--num_envs=8", "--rollout=8", "--batch_size=32", "--with_pbt=True",
        f"--num_policies={P}", "--pbt_start_mutation=0", "--pbt_period_env_steps=1", "--pbt_mutation_rate=1.0",
        "--pbt_replace_fraction=0.5", "--pbt_replace_reward_gap=0.01", "--pbt_replace_reward_gap_absolute=1e-4",
        "--seed=42", "--device=cpu", f"--train_dir={train_dir}", "--experiment=pbt"])
    info = extract_env_info(SyntheticVectorDiscreteEnv(), cfg)
    gen = torch.Generator().manual_seed(0)
    population = [init_train_state(cfg, info, create_actor_critic(cfg, info.obs_space, info.action_space, gen), "cpu")
                  for _ in range(P)]
    local_objectives = [0.1, 5.0, 1.0, 3.0] if rank == 0 else [5.0, 0.1, 3.0, 1.0]
    for name, objectives in (("local", list(local_objectives)), ("sync", broadcast_objectives(list(local_objectives)))):
        states = copy.deepcopy(population)
        pbt = PopulationBasedTraining(cfg, P)
        pbt.on_training_step(states, [10] * P, objectives)
        out[f"pbt_{name}"] = {"objectives": objectives, "hparams": pbt.policy_hparams,
                              "train_steps": [ts.train_step for ts in states]}

    writer = SummaryWriter(cfg, 0)
    writer.write(0, {"x": 1.0})
    writer.close()
    out["writer_noop"] = writer._noop
    sync_barrier()
    return out


def _runner_cases(rank, train_dir):
    """The clocks cross --train_for_seconds on different iterations: rank 1's after its second
    iteration, rank 0's never. Then the run resumes for one more iteration."""
    import sample_factory_tpu_torch.runner.runner as runner_module
    from sample_factory_tpu_torch.parallel.multihost import sync_barrier

    class ClockJump(runner_module.AlgoObserver):
        def __init__(self):
            self.iterations = 0

        def on_training_iteration(self, runner, stats):
            self.iterations += 1
            if rank == 1 and self.iterations == 2:
                runner._start_time -= 1e6

    saves = []
    save_checkpoint = runner_module.save_checkpoint

    def counting_save(*args, **kwargs):
        saves.append(args[3])  # env_steps
        return save_checkpoint(*args, **kwargs)

    runner_module.save_checkpoint = counting_save
    clock = ClockJump()
    distributed = ["--jax_distributed=True"]
    runner, trajectories = _run_runner(_runner_argv(train_dir, 320, "dp", distributed + ["--train_for_seconds=3600"]), [clock])
    sync_barrier()  # rank 0's final checkpoint is on disk
    ckpt_dir = os.path.join(train_dir, "dp", "checkpoint_p0")
    out = {"iterations": clock.iterations, "env_steps": runner.env_steps, "saves": list(saves),
           "checkpoints": sorted(os.listdir(ckpt_dir)), "params": _params(runner),
           "trajectory": trajectories[0], "shard": runner.sampler_state.shard}

    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.train import make_rl_runner

    _, resumed = make_rl_runner(parse_custom_args(_runner_argv(train_dir, 256, "dp", distributed)))
    resumed.init()
    out["resumed_env_steps"] = resumed.env_steps
    out["resumed_train_step"] = resumed.train_state.train_step
    out["resumed_params_equal"] = all(torch.equal(v, out["params"][k]) for k, v in _params(resumed).items())
    assert resumed.run() == 0
    out["resumed_final_env_steps"] = resumed.env_steps
    out["resumed_final_params"] = _params(resumed)
    out["saves_after_resume"] = list(saves)

    # once more, with rank 1 in a train_dir that holds no checkpoint: it takes rank 0's state and env steps
    own_dir = train_dir if rank == 0 else train_dir + "_empty"
    _, again = make_rl_runner(parse_custom_args(_runner_argv(own_dir, 320, "dp", distributed)))
    again.init()
    out["empty_start"] = {"env_steps": again.env_steps, "train_step": again.train_state.train_step,
                          "curr_lr": again.train_state.curr_lr, "optimizer_state": len(again.train_state.optimizer.state),
                          "params": _params(again)}
    assert again.run() == 0
    out["empty_final"] = {"env_steps": again.env_steps, "params": _params(again), "saves": saves[len(out["saves_after_resume"]):]}
    runner_module.save_checkpoint = save_checkpoint
    return out


def _population_case(rank, train_dir):
    """The population runner under the group: 2 policies on every rank (no sharding) and PBT,
    whose objectives rank each rank's policies the other way round; rank 0's are broadcast."""
    import sample_factory_tpu_torch.runner.runner as runner_module

    class Objectives(runner_module.AlgoObserver):
        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[0.0], [10.0]] if rank == 0 else [[10.0], [0.0]]

    pbt = ["--num_policies=2", "--with_pbt=True", "--pbt_start_mutation=0", "--pbt_period_env_steps=32", "--use_rnn=False",
           "--jax_distributed=True"]
    runner, _ = _run_runner(_runner_argv(train_dir, 128, "population", pbt), [Objectives()])
    return {"type": type(runner).__name__, "env_steps": runner.env_steps, "hparams": runner.pbt.policy_hparams,
            "train_steps": [ts.train_step for ts in runner.train_state],
            "params": [{k: v.clone() for k, v in ts.model.state_dict().items()} for ts in runner.train_state]}


def _child(out_dir, rank, world, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.parallel.mesh import make_mesh

    multihost.init_distributed(backend="gloo")
    out = {"world": multihost.world_size(), "rank": multihost.process_index()}
    train_dir = os.path.join(out_dir, f"train_w{world}")
    try:
        if world == 2:
            out.update(_helper_cases(rank, train_dir))
            mesh = make_mesh(default_cfg(env="e", argv=["--device=cpu"]))
            out["mesh"] = {"world": mesh.world, "rank": mesh.rank, "data": mesh.data, "device": str(mesh.device)}
            out["learner"] = {case: _learner_call(case, mesh) for case in LEARNER_CASES}
            out["runner"] = _runner_cases(rank, train_dir)
            out["population"] = _population_case(rank, train_dir)
        else:
            runner, trajectories = _run_runner(_runner_argv(train_dir, 128, "w1", ["--jax_distributed=True"]))
            out["world1"] = {"params": _params(runner), "trajectories": trajectories, "stats": runner.host_stats(),
                             "env_steps": runner.env_steps}
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(out_dir, f"w{world}_rank{rank}.pt"))


# ------------------------------------------------------------------ fixture


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Start the two ranks and the world of one once; {(world, rank): what each saved}."""
    out_dir = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    ports = {2: _free_port(), 1: _free_port()}
    procs = {}
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        code = (f"import sys; sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_multihost as t; "
                f"t._child({str(out_dir)!r}, {rank}, {world}, {ports[world]})")
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
    return {key: torch.load(out_dir / f"w{key[0]}_rank{key[1]}.pt", weights_only=False) for key in procs}


def _ranks(dp):
    return dp[(2, 0)], dp[(2, 1)]


# ------------------------------------------------------------------ the helpers, PBT, the writer


def test_helpers_cross_process(dp):
    for rank, r in enumerate(_ranks(dp)):
        assert r["world"] == 2 and r["rank"] == rank and r["primary"] == (rank == 0)
        assert r["mesh"] == {"world": 2, "rank": rank, "data": 2, "device": "cpu"}
        assert r["bcast"] == [7]


def test_pbt_diverges_without_broadcast(dp):
    r0, r1 = (r["pbt_local"] for r in _ranks(dp))
    assert r0["hparams"] != r1["hparams"] or r0["train_steps"] != r1["train_steps"]


def test_pbt_agrees_with_broadcast(dp):
    r0, r1 = (r["pbt_sync"] for r in _ranks(dp))
    assert r0["objectives"] == r1["objectives"] == [0.1, 5.0, 1.0, 3.0]
    assert r0["hparams"] == r1["hparams"] and r0["train_steps"] == r1["train_steps"]


def test_writer_gated_to_primary(dp):
    r0, r1 = _ranks(dp)
    assert r0["writer_noop"] is False and r1["writer_noop"] is True


# ------------------------------------------------------------------ 2 ranks x N/2 envs = 1 rank x N envs


@pytest.mark.parametrize("case", list(LEARNER_CASES))
def test_two_ranks_equal_one_rank_after_a_train_call(dp, case):
    want = _learner_call(case)
    for r in _ranks(dp):
        got = r["learner"][case]
        for name, value in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=name)
        for key in ("obs_rms", "returns_rms"):
            for name, value in (want[key] or {}).items():
                np.testing.assert_allclose(got[key][name].numpy(), value.numpy(), atol=1e-5, rtol=1e-6, err_msg=f"{key}.{name}")
        assert got["train_step"] == want["train_step"]
        assert got["curr_lr"] == pytest.approx(want["curr_lr"], rel=1e-6)
        for key in ("loss", "policy_loss", "value_loss", "kl_divergence", "adv_mean", "adv_std", "valids_fraction",
                    "epochs_executed", "version_diff_max", "ratio_min", "ratio_max", "max_abs_logprob", "grad_norm"):
            np.testing.assert_allclose(got["stats"][key], want["stats"][key], atol=1e-5, rtol=1e-5, err_msg=key)
    r0, r1 = (r["learner"][case]["params"] for r in _ranks(dp))
    assert all(torch.equal(r0[k], r1[k]) for k in r0)  # the replicas stay identical
    if case == "vtrace_lagged":
        assert want["stats"]["valids_fraction"] < 0.75  # rank 1's lagged envs are masked out


def test_two_ranks_equal_jax(dp):
    """The JAX train call (one device, which GSPMD's data-parallel program equals) from the
    same initial parameters on the whole trajectory: the two ranks' parameters to 1e-5."""
    import jax
    import jax.numpy as jnp

    from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
    from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn
    from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
    from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
    from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo
    from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
    from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
    from sample_factory_tpu_torch import bridge

    case = "gae_contiguous"
    cfg, _, ts, traj = _learner_setup(case)
    jcfg = jax_default_cfg(env="e", argv=[a for a in LEARNER_ARGV if a != "--device=cpu"] + LEARNER_CASES[case])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox(OBS)}), action_space=JDiscrete(6), num_agents=1, is_device_env=True)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2,) + OBS)})
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(ts.model.state_dict(), ts.model))
    jts = jts.replace(params=params, opt_state=tx.init(params))
    jts2, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, _map(traj, lambda x: jnp.asarray(x.numpy())), jax.random.PRNGKey(1))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), ts.model)
    for r in _ranks(dp):
        for name, value in r["learner"][case]["params"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


# ------------------------------------------------------------------ the runner


@pytest.fixture(scope="module")
def one_rank_run(tmp_path_factory):
    """The runner's configuration without a group, 8 envs, 3 iterations."""
    runner, trajectories = _run_runner(_runner_argv(tmp_path_factory.mktemp("one_rank"), 192, "one"))
    return runner, trajectories


def test_rollout_rows_equal_one_rank_exactly(dp, one_rank_run):
    _, trajectories = one_rank_run
    want = trajectories[0]
    for rank, r in enumerate(_ranks(dp)):
        got, shard = r["runner"]["trajectory"], r["runner"]["shard"]
        assert (shard.start, shard.stop, shard.total) == (4 * rank, 4 * rank + 4, 8)
        for key, value in want.items():
            for name, v in (value.items() if isinstance(value, dict) else [(key, value)]):
                g = got[key][name] if isinstance(value, dict) else got[key]
                assert torch.equal(g, v[:, shard.start : shard.stop]), name
    # the ranks stepped different episodes
    r0, r1 = (r["runner"]["trajectory"]["obs"]["obs"] for r in _ranks(dp))
    assert not torch.equal(r0, r1)


def test_replicas_identical_and_equal_to_one_rank_after_three_iterations(dp, one_rank_run):
    runner, _ = one_rank_run
    r0, r1 = (r["runner"] for r in _ranks(dp))
    assert r0["iterations"] == r1["iterations"] == 3
    for name, value in _params(runner).items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        np.testing.assert_allclose(r0["params"][name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_stop_is_agreed(dp):
    """Rank 1's clock crossed --train_for_seconds after its second iteration and rank 0's
    never: both ran a third iteration (the stop agreed then) and no fourth, short of the
    five that --train_for_env_steps allows."""
    for r in _ranks(dp):
        assert r["runner"]["iterations"] == 3 and r["runner"]["env_steps"] == 3 * 64


def test_only_rank0_writes_a_checkpoint_and_both_resume(dp):
    r0, r1 = (r["runner"] for r in _ranks(dp))
    assert r0["saves"] == [192] and r1["saves"] == []  # the final save, on rank 0 alone
    assert r0["checkpoints"] == r1["checkpoints"] == ["checkpoint_000000000006_192.pth"]
    for r in (r0, r1):
        assert r["resumed_env_steps"] == 192 and r["resumed_train_step"] == 6 and r["resumed_params_equal"]
        assert r["resumed_final_env_steps"] == 256
    assert r0["saves_after_resume"] == [192, 256] and r1["saves_after_resume"] == []
    assert all(torch.equal(r0["resumed_final_params"][k], v) for k, v in r1["resumed_final_params"].items())



def test_resume_takes_rank0s_state_where_a_rank_has_no_checkpoint(dp):
    """Rank 1's train_dir holds no checkpoint: it starts from rank 0's parameters, optimizer
    state, train step, learning rate and env steps, and stops with rank 0 on the env-step count."""
    r0, r1 = (r["runner"] for r in _ranks(dp))
    for r in (r0, r1):
        start = r["empty_start"]
        assert start["env_steps"] == 256 and start["train_step"] == 8 and start["optimizer_state"] > 0
        assert all(torch.equal(v, r0["resumed_final_params"][k]) for k, v in start["params"].items())
        assert r["empty_final"]["env_steps"] == 320
    assert r0["empty_start"]["curr_lr"] == r1["empty_start"]["curr_lr"]
    assert all(torch.equal(v, r0["empty_final"]["params"][k]) for k, v in r1["empty_final"]["params"].items())
    assert r0["empty_final"]["saves"] == [320] and r1["empty_final"]["saves"] == []

def test_population_runner_agrees_under_a_group(dp):
    """Each rank runs the whole population; rank 0's objectives reach rank 1, so both take rank
    0's PBT decision (policy 0, its worst, takes policy 1's weights) and stay identical."""
    r0, r1 = (r["population"] for r in _ranks(dp))
    assert r0["type"] == "MultiPolicyRunner" and r0["env_steps"] == r1["env_steps"] == 128
    assert r0["hparams"] == r1["hparams"] and r0["train_steps"] == r1["train_steps"]
    assert r0["train_steps"][0] > r0["train_steps"][1]  # the replaced policy's version jumps (max_policy_lag + 1)
    for p0, p1 in zip(r0["params"], r1["params"]):
        assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_world_of_one_equals_no_group_bit_for_bit(dp, tmp_path):
    got = dp[(1, 0)]["world1"]
    runner, trajectories = _run_runner(_runner_argv(tmp_path, 128, "w1"))
    assert got["env_steps"] == runner.env_steps == 128
    for name, value in _params(runner).items():
        assert torch.equal(got["params"][name], value), name
    for g, w in zip(got["trajectories"], trajectories):
        assert torch.equal(g["actions"], w["actions"]) and torch.equal(g["action_logits"], w["action_logits"])
    assert got["stats"] == runner.host_stats()


def test_no_group_train_call_makes_no_distributed_call(tmp_path, monkeypatch):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    _, runner = make_rl_runner(parse_custom_args(_runner_argv(tmp_path, 64, "nogroup")))
    runner.init()

    def refuse(*args, **kwargs):
        raise AssertionError("torch.distributed called without a process group")

    for name in ("is_initialized", "is_available", "get_rank", "get_world_size", "get_backend", "all_reduce",
                 "broadcast", "broadcast_object_list", "barrier", "init_process_group"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    ts = runner.train_state
    runner.sampler_state, traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state, ts.train_step, 0)
    stats = runner._train_fn(ts, traj, runner.train_generator)
    assert ts.train_step == 2 and np.isfinite(float(stats["loss"]))


def test_mesh_layout_and_refusals(monkeypatch):
    from sample_factory_tpu_torch.parallel import mesh as mesh_module
    from sample_factory_tpu_torch.parallel.multihost import init_distributed

    cfg = default_cfg(env="e", argv=["--device=cpu"])
    m = mesh_module.make_mesh(cfg)
    assert (m.world, m.rank, m.data, m.model, m.distributed, m.device) == (1, 0, 1, 1, False, torch.device("cpu"))
    assert mesh_module.num_data_shards(m) == 1 and mesh_module.num_data_shards(None) == 1
    assert mesh_module.mesh_axes(cfg, 8) == (8, 1)
    assert mesh_module.mesh_axes(default_cfg(env="e", argv=["--mesh_model=2"]), 8) == (4, 2)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        mesh_module.mesh_axes(default_cfg(env="e", argv=["--mesh_data=2"]), 1)
    two = mesh_module.Mesh(world=2, rank=1, data=2, model=1, device=torch.device("cpu"), distributed=True)
    shard = mesh_module.shard_env_axis(two, 1024)
    assert (shard.start, shard.stop, shard.total, shard.size) == (512, 1024, 1024, 512)
    with pytest.raises(ValueError, match="divide over 2"):
        mesh_module.shard_env_axis(two, 1023)
    # without a model axis nothing is sharded
    model = torch.nn.Linear(1024, 1024)
    assert mesh_module.shard_params_tp(model, two) is None and model.weight.shape == (1024, 1024)
    # a 2 x 2 mesh: rank r at data index r // 2 and model index r % 2, the envs by data index
    layout = []
    for rank in range(4):
        m = mesh_module.Mesh(world=4, rank=rank, data=2, model=2, device=torch.device("cpu"), distributed=True)
        shard = mesh_module.shard_env_axis(m, 1024)
        layout.append((m.data_index, m.model_index, m.model_axis.index, m.model_axis.size, shard.start, shard.stop))
    assert layout == [(0, 0, 0, 2, 0, 512), (0, 1, 1, 2, 0, 512), (1, 0, 0, 2, 512, 1024), (1, 1, 1, 2, 512, 1024)]
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT not set"):
        init_distributed(cfg)
    # a card that is not there is refused, never replaced by the CPU or another index
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=3 but this host has 1 CUDA device"):
        mesh_module._rank_device(default_cfg(env="e", argv=["--device=gpu"]))

