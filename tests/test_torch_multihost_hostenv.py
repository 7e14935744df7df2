"""Data parallelism of the host runners (ROADMAP A13b) on torch.distributed: the
counterparts of `tests/test_multihost_hostenv.py`, with two gloo ranks on the CPU, small
enough to run in tier-1.

A module fixture starts three processes once: two ranks of one group (world 2) and one rank
alone in another (world 1). Each runs `_child` and saves what it saw. The configuration is
the JAX test's child (`__graft_entry__.py:295-304`: `tiny_env`, serial mode, 2 workers x 4
envs in 2 splits, rollout 8, batch 64, MLP 16-16, sync) and small variants of it. The ranks
run `HostEnvRunner` in it (rank 1's clock crosses `--train_for_seconds` after its second
iteration), in four variants of the learner (sync fused, async quantized shuffled over three
epochs, async quantized with a GRU-16, async quantized whose early stop fires), and
`HostMultiPolicyRunner` with PBT in both regimes; each records its first train call (and the
quantized learner the epoch losses that its early-stop checks read). They also run the
quantized learner on their halves of a V-trace trajectory with lagged versions, and the
fused and quantized learners on one trajectory. This process computes the one-rank
references without a group and compares:

- 2 ranks, each with its own sampler, equal 1 rank handed both ranks' trajectories joined on
  the env axis in rank order, to 1e-5 (float32): parameters, train steps and stats; one
  case against the JAX train call too;
- the ranks' samplers are decorrelated, in their envs and in their action draws (ROADMAP C:
  P1); every rank reports the global episode sums, stops on the same iteration, and makes one
  collective an iteration outside the learner (P2); only rank 0 writes, and a resume in which
  rank 1 has no checkpoint starts both ranks from rank 0's state and env steps;
- a world of one equals a run without a group bit for bit;
- the JAX quantized learner of several processes trains on process 0's rows only (J1).
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn, select_minibatches
from sample_factory_tpu_torch.algo.quantized_train import QuantizedTrainer
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.env_info import EnvInfo
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 150
OBS_DIM, ACTIONS = 6, 3
ENVS_PER_RANK, ROLLOUT = 8, 8  # 2 workers x 4 envs
# the JAX test's child, without its experiment and train_dir
BASE = [
    "--env=tiny_env", "--device=cpu", "--serial_mode=True", "--num_workers=2", "--num_envs_per_worker=4",
    "--worker_num_splits=2", f"--rollout={ROLLOUT}", "--batch_size=64", "--num_epochs=1", "--use_rnn=False",
    "--encoder_mlp_layers", "16", "16", "--async_rl=False", "--seed=11", "--experiment_summaries_interval=10000",
    "--save_every_sec=10000", "--save_best_every_sec=10000", "--decorrelate_envs_on_one_worker=False",
]
# variants of the learner, each run for two iterations: the first train step is flushed in the second
RUNNER_CASES = {
    "async_quantized_shuffled": ["--async_rl=True", "--shuffle_minibatches=True", "--num_epochs=3", "--batch_size=32"],
    "async_quantized_gru": ["--async_rl=True", "--use_rnn=True", "--rnn_size=16", "--recurrence=8", "--shuffle_minibatches=True",
                            "--num_epochs=2", "--batch_size=32"],
    # lr 0 freezes the parameters: every epoch's mean policy loss is the same, so the third and fourth epochs are skipped
    "async_quantized_early_stop": ["--async_rl=True", "--num_epochs=4", "--learning_rate=0.0", "--lr_schedule=constant"],
}
SYNC_ITERATIONS = 4  # rank 1's clock crosses --train_for_seconds after iteration 2: the stop is agreed in 3, read in 4
LEARNER_CASES = {
    # the quantized learner on each rank's half of a crafted trajectory, at train step 10 with --max_policy_lag=5:
    # rank 1's envs hold fewer valid steps than rank 0's
    "vtrace_lagged": ["--async_rl=True", "--use_rnn=True", "--rnn_size=16", f"--recurrence={ROLLOUT}", "--with_vtrace=True",
                      "--vtrace_rho=0.9", "--vtrace_c=1.1", "--max_policy_lag=5", "--batch_size=64", "--num_epochs=2",
                      "--shuffle_minibatches=True"],
}
LAGGED_TRAIN_STEP = 10


# ------------------------------------------------------------------ envs (imported by the children)


def _tiny_env_cls(constant: bool):
    import gymnasium as gym

    class TinyEnv(gym.Env):
        """The JAX test's env: a new normal observation a step, reward = the action, 12 steps.
        `constant`: the observation is always zero, so that only the action draws tell envs apart."""

        observation_space = gym.spaces.Box(-10, 10, (OBS_DIM,), np.float32)
        action_space = gym.spaces.Discrete(ACTIONS)

        def __init__(self):
            self.rng, self.t = None, 0

        def _obs(self):
            return np.zeros(OBS_DIM, np.float32) if constant else self.rng.normal(size=OBS_DIM).astype(np.float32)

        def reset(self, seed=None, options=None):
            if seed is not None or self.rng is None:
                self.rng = np.random.default_rng(seed if seed is not None else 0)
            self.t = 0
            return self._obs(), {}

        def step(self, a):
            self.t += 1
            return self._obs(), float(a), self.t >= 12, False, {}

    return TinyEnv


def register_tiny_envs():
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for name, constant in (("tiny_env", False), ("const_env", True)):
        register_env(name, lambda _n, _c, _e, render_mode=None, constant=constant: _tiny_env_cls(constant)())


# ------------------------------------------------------------------ shared by the children and the tests


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _floats(stats):
    return {k: float(v) for k, v in stats.items()}


def _parse(argv):
    from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args

    parser, _ = parse_sf_args(argv)
    return parse_full_cfg(parser, argv)


def _crafted_trajectory(n_envs, lagged, rnn_size=16):
    """Time-major [T(+1), n_envs, ...] from a seed, in the host sampler's schema. Env 1's last
    steps come from another policy; with `lagged`, the envs of the second half were collected
    7 versions ago (and env n-1's first steps 5 ago), so that at train step 10 with
    --max_policy_lag=5 they are invalid."""
    rng = np.random.default_rng(0)
    T = ROLLOUT
    dones = (rng.random((T, n_envs)) < 0.15).astype(np.float32)
    versions = np.full((T, n_envs), 8 if lagged else 0, np.int32)
    if lagged:
        versions[:, n_envs // 2 : n_envs - 1] = 3
        versions[:3, n_envs - 1] = 5
    traj = {
        "obs": {"obs": rng.normal(size=(T + 1, n_envs, OBS_DIM)).astype(np.float32)},
        "rnn_states": (rng.normal(size=(T + 1, n_envs, rnn_size)) * 0.5).astype(np.float32),
        "actions": rng.integers(0, ACTIONS, size=(T, n_envs, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, n_envs, ACTIONS)).astype(np.float32),
        "log_prob_actions": np.log(rng.uniform(0.2, 0.5, size=(T, n_envs))).astype(np.float32),
        "values": rng.normal(size=(T, n_envs)).astype(np.float32),
        "rewards": rng.normal(size=(T, n_envs)).astype(np.float32),
        "dones": dones,
        "time_outs": dones * (rng.random((T, n_envs)) < 0.5),
        "policy_version": versions,
        "policy_id": np.where((np.arange(n_envs)[None] == 1) & (np.arange(T)[:, None] >= 5), 1, 0).astype(np.int32),
    }
    return _map(traj, torch.tensor)


def _env_info():
    return EnvInfo(obs_space=make_dict_spec({"obs": Box((OBS_DIM,))}), action_space=Discrete(ACTIONS), num_agents=1,
                   is_device_env=False)


def _train_state(cfg, env_info, state=None):
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(0))
    ts = init_train_state(cfg, env_info, model, "cpu")
    if state is not None:
        ts.load_state_dict(copy.deepcopy(state))
    return ts


def _epoch_losses(q):
    """Run the queued quanta; the epoch-mean policy losses that the early-stop checks read."""
    while q.dispatch_one():
        pass
    return [float(x) for x in q._state["epoch_losses"]]


def _quantized_call(cfg, env_info, ts, traj, generator, mesh=None):
    """-> (stats, the epoch-mean policy losses)."""
    q = QuantizedTrainer(cfg, env_info, 0, num_envs=traj["rewards"].shape[1], mesh=mesh)
    q.enqueue(ts, traj, generator)
    losses = _epoch_losses(q)
    return q.flush(), losses


def _train_call(cfg, env_info, ts, traj, mesh=None):
    """The host runner's learner on `traj` with the runner's train generator: quantized in async
    mode, the fused call in sync mode. -> (stats, the quantized learner's epoch losses or None)."""
    generator = torch.Generator().manual_seed(cfg.seed + 2)
    if cfg.async_rl:
        return _quantized_call(cfg, env_info, ts, traj, generator, mesh)
    return make_train_fn(cfg, env_info, 0, mesh)(ts, traj, generator), None


def _first_call_record(ts, traj, stats, before, cfg, env_info, epoch_losses=None):
    return {"traj": traj, "before": before, "after": _params(ts.model), "stats": _floats(stats), "train_step": ts.train_step,
            "curr_lr": ts.curr_lr, "cfg": dict(cfg), "env_info": env_info, "epoch_losses": epoch_losses}


# ------------------------------------------------------------------ the child processes


class _Recorder:
    """Instruments an initialised host runner: each rollout's local episode count and actions,
    every iteration's losses, the first train call (trajectory, state before, parameters
    and stats after), and the collectives made between two iterations."""

    def __init__(self, runner, clock_jump_after=None):
        import sample_factory_tpu_torch.runner.runner as runner_module

        self.runner, self.clock_jump_after = runner, clock_jump_after
        self.local_episodes, self.actions, self.losses, self.events, self.first = [], [], [], [], {}
        self.iterations = 0
        collect = runner.sampler.collect_rollout

        def recording_collect(*args, **kwargs):
            traj, ep_stats = collect(*args, **kwargs)
            self.local_episodes.append(ep_stats["count"])
            self.actions.append(traj["actions"].clone())
            return traj, ep_stats

        runner.sampler.collect_rollout = recording_collect
        train_iteration = runner._train_iteration

        def marked_iteration():
            self.events.append("start")
            out = train_iteration()
            self.events.append("end")
            return out

        runner._train_iteration = marked_iteration
        if getattr(runner, "_quantizer", None) is not None:
            self._wrap_quantizer(runner._quantizer)
        else:
            self._wrap_train_fn()

        recorder = self

        class Observer(runner_module.AlgoObserver):
            def on_training_iteration(self, runner, stats):
                recorder.iterations += 1
                if stats:
                    per_policy = stats if isinstance(stats, list) else [stats]
                    recorder.losses.append([float(s["loss"]) for s in per_policy])
                if recorder.iterations == recorder.clock_jump_after:
                    runner._start_time -= 1e6

        runner.register_observer(Observer())

    def _record_before(self, ts, traj):
        self.first.update(traj=_map(traj, lambda x: x.clone()), before=copy.deepcopy(ts.state_dict()))

    def _record_after(self, ts, stats, epoch_losses=None):
        runner = self.runner
        self.first.update(_first_call_record(ts, self.first["traj"], stats, self.first["before"], runner.cfg, runner.env_info,
                                             epoch_losses))

    def _wrap_train_fn(self):
        train_fn = self.runner._train_fn

        def recording(ts, traj, generator, *args, **kwargs):
            if self.first:
                return train_fn(ts, traj, generator, *args, **kwargs)
            self._record_before(ts, traj)
            stats = train_fn(ts, traj, generator, *args, **kwargs)
            self._record_after(ts, stats)
            return stats

        self.runner._train_fn = recording

    def _wrap_quantizer(self, q):
        enqueue, flush = q.enqueue, q.flush

        def recording_enqueue(ts, traj, generator):
            if not self.first:
                self._record_before(ts, traj)
            return enqueue(ts, traj, generator)

        def recording_flush():
            if "after" in self.first:
                return flush()
            losses = _epoch_losses(q)
            stats = flush()
            self._record_after(self.runner.train_state, stats, losses)
            return stats

        q.enqueue, q.flush = recording_enqueue, recording_flush

    def collectives_between_iterations(self):
        """The collectives made after each iteration and before the next (the first entry: before
        the first iteration)."""
        counts, n = [], 0
        for event in self.events:
            if event == "c":
                n += 1
            elif event == "start":
                counts.append(n)
            else:
                n = 0
        return counts


def _count_collectives(sink):
    """Every torch.distributed collective appends "c" to the list in `sink[0]` (None: counts nothing)."""
    import torch.distributed as dist

    for name in ("all_reduce", "broadcast", "broadcast_object_list", "barrier", "all_gather", "all_gather_object"):
        original = getattr(dist, name)

        def counted(*args, _original=original, **kwargs):
            if sink[0] is not None:
                sink[0].append("c")
            return _original(*args, **kwargs)

        setattr(dist, name, counted)


def _run(argv, clock_jump_after=None, observers=(), sink=None):
    """make_rl_runner -> init -> run, as run_rl does (under a child's group, or without one)."""
    from sample_factory_tpu_torch.train import make_rl_runner

    _, runner = make_rl_runner(_parse(argv), register_fn=register_tiny_envs)
    for observer in observers:
        runner.register_observer(observer)
    runner.init()
    recorder = _Recorder(runner, clock_jump_after)
    if sink is not None:
        sink[0] = recorder.events
    assert runner.run() == 0
    if sink is not None:
        sink[0] = None
    return runner, recorder


def _saves():
    """Wrap save_checkpoint where the runners call it; the list of each call's env steps."""
    import sample_factory_tpu_torch.runner.multi_policy_runner as mp_module
    import sample_factory_tpu_torch.runner.runner as runner_module

    saves = []
    for module in (runner_module, mp_module):
        original = module.save_checkpoint

        def counting(*args, _original=original, **kwargs):
            saves.append(args[3])
            return _original(*args, **kwargs)

        module.save_checkpoint = counting
    return saves


def _host_env_case(rank, world, train_dir, saves, sink):
    """The JAX test's configuration through HostEnvRunner: rank 1's clock jumps after iteration 2."""
    from sample_factory_tpu_torch.parallel.multihost import sync_barrier

    steps = SYNC_ITERATIONS * ENVS_PER_RANK * ROLLOUT * world
    extra = [f"--train_for_env_steps={10 * steps if world == 2 else steps}", "--train_for_seconds=3600"]
    argv = BASE + extra + [f"--train_dir={train_dir}", "--experiment=mh_host", "--jax_distributed=True"]
    runner, rec = _run(argv, clock_jump_after=2 if rank == 1 else None, sink=sink)
    sync_barrier()  # rank 0's final checkpoint is on disk
    ckpt_dir = os.path.join(train_dir, "mh_host", "checkpoint_p0")
    return {
        "type": type(runner).__name__, "env_seed_offset": runner.cfg.env_seed_offset, "first_obs": rec.first["traj"]["obs"]["obs"][0],
        "iterations": rec.iterations, "losses": rec.losses, "env_steps": runner.env_steps, "local_episodes": rec.local_episodes,
        "episodes": runner.episode_stats.total_episodes, "rewards": list(runner.episode_stats.rewards),
        "avg_reward": runner.episode_stats.avg_reward, "collectives": rec.collectives_between_iterations(),
        "saves": list(saves), "checkpoints": sorted(os.listdir(ckpt_dir)), "writer_noop": runner.writer._noop,
        "done_file": os.path.isfile(os.path.join(train_dir, "mh_host", "done")), "first": rec.first,
        "params": _params(runner.train_state.model), "actions": rec.actions,
    }


def _resume_case(rank, out_dir, host, saves):
    """The host case's run resumed for 2 more iterations: rank 0 from its checkpoint, rank 1 from
    a train_dir that holds none. Both must start from rank 0's state and env steps."""
    train_dir = os.path.join(out_dir, "train_w2" if rank == 0 else "train_w2_empty")
    steps = host["env_steps"] + 2 * 2 * ENVS_PER_RANK * ROLLOUT
    argv = BASE + [f"--train_for_env_steps={steps}", "--train_for_seconds=3600", f"--train_dir={train_dir}",
                   "--experiment=mh_host", "--jax_distributed=True"]
    from sample_factory_tpu_torch.train import make_rl_runner

    _, runner = make_rl_runner(_parse(argv), register_fn=register_tiny_envs)
    runner.init()
    ts = runner.train_state
    out = {"start_env_steps": runner.env_steps, "start_train_step": ts.train_step, "start_curr_lr": ts.curr_lr,
           "start_optimizer_state": len(ts.optimizer.state), "start_params": _params(ts.model)}
    rec = _Recorder(runner)
    saves_before = len(saves)
    assert runner.run() == 0
    return {**out, "iterations": rec.iterations, "env_steps": runner.env_steps, "train_step": runner.train_state.train_step,
            "params": _params(runner.train_state.model), "saves": saves[saves_before:]}


def _population_case(rank, train_dir, regime):
    """HostMultiPolicyRunner (`regime`: sync or async): 2 policies, PBT every iteration; each rank's
    objectives rank its policies the other way round, and rank 0's are broadcast."""
    import sample_factory_tpu_torch.runner.runner as runner_module

    class Objectives(runner_module.AlgoObserver):
        def __init__(self):
            self.objectives = []

        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[0.0], [10.0]] if rank == 0 else [[10.0], [0.0]]
            on_training_step = runner.pbt.on_training_step

            def recording(states, steps, objectives):
                self.objectives.append(list(objectives))
                return on_training_step(states, steps, objectives)

            runner.pbt.on_training_step = recording

    objectives = Objectives()
    argv = BASE + ["--num_policies=2", "--with_pbt=True", "--pbt_start_mutation=0", "--pbt_period_env_steps=64",
                   f"--train_for_env_steps={3 * 2 * ENVS_PER_RANK * ROLLOUT}", f"--train_dir={train_dir}", f"--experiment=mh_host_mp_{regime}",
                   f"--async_rl={regime == 'async'}", "--jax_distributed=True"]
    runner, rec = _run(argv, observers=[objectives])
    return {"type": type(runner).__name__, "losses": rec.losses, "env_steps": runner.env_steps,
            "episodes": [es.total_episodes for es in runner.episode_stats_per_policy], "local_episodes": rec.local_episodes,
            "objectives": objectives.objectives, "hparams": runner.pbt.policy_hparams,
            "params": [_params(ts.model) for ts in runner.train_state]}


def _learner_cases(mesh):
    """The quantized learner on this rank's half of a crafted trajectory; then the fused and the
    quantized learner on one trajectory (shuffled, 3 epochs)."""
    out = {}
    info = _env_info()
    for case, extra in LEARNER_CASES.items():
        cfg = default_cfg(env="e", argv=["--device=cpu", "--seed=0", f"--rollout={ROLLOUT}", *extra, "--encoder_mlp_layers", "16"])
        ts = _train_state(cfg, info)
        ts.train_step = LAGGED_TRAIN_STEP
        before = copy.deepcopy(ts.state_dict())
        traj = _crafted_trajectory(2 * ENVS_PER_RANK, lagged=True)
        lo = mesh.rank * ENVS_PER_RANK
        traj = _map(traj, lambda x: x[:, lo : lo + ENVS_PER_RANK].clone())
        stats, losses = _train_call(cfg, info, ts, traj, mesh)
        out[case] = _first_call_record(ts, traj, stats, before, cfg, info, losses)
    cfg = default_cfg(env="e", argv=["--device=cpu", "--seed=0", f"--rollout={ROLLOUT}", "--shuffle_minibatches=True", "--num_epochs=3", "--batch_size=32",
                                     "--use_rnn=False", "--encoder_mlp_layers", "16"])
    traj = _map(_crafted_trajectory(2 * ENVS_PER_RANK, lagged=False, rnn_size=1), lambda x: x[:, mesh.rank * ENVS_PER_RANK : (mesh.rank + 1) * ENVS_PER_RANK])
    updates = {}
    for name, call in (("fused", lambda ts, g: make_train_fn(cfg, info, 0, mesh)(ts, traj, g)),
                       ("quantized", lambda ts, g: _quantized_call(cfg, info, ts, traj, g, mesh)[0])):
        ts = _train_state(cfg, info)
        stats = call(ts, torch.Generator().manual_seed(5))
        updates[name] = {"params": _params(ts.model), "stats": _floats(stats), "train_step": ts.train_step}
    out["fused_vs_quantized"] = updates
    return out


def _const_env_actions(train_dir, distributed):
    """The first rollout's actions on `const_env` (observations all zero), through the host runner."""
    from sample_factory_tpu_torch.train import make_rl_runner

    argv = BASE + ["--env=const_env", f"--train_dir={train_dir}", "--experiment=const"] + (["--jax_distributed=True"] if distributed else [])
    _, runner = make_rl_runner(_parse(argv), register_fn=register_tiny_envs)
    runner.init()
    try:
        ts = runner.train_state
        traj, _ = runner.sampler.collect_rollout(ts.model, ts.obs_rms, ts.train_step, 0)
        return traj["actions"]
    finally:
        runner._release_resources()
        runner._close_writers()


def _child(out_dir, rank, world, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.parallel.mesh import make_mesh
    from sample_factory_tpu_torch.train import make_rl_runner

    register_tiny_envs()
    multihost.init_distributed(backend="gloo")
    sink = [None]
    _count_collectives(sink)
    saves = _saves()
    train_dir = os.path.join(out_dir, f"train_w{world}")
    out = {"world": multihost.world_size(), "rank": multihost.process_index()}
    try:
        out["host"] = _host_env_case(rank, world, train_dir, saves, sink)
        if world == 2:
            out["resume"] = _resume_case(rank, out_dir, out["host"], saves)
            out["const_actions"] = _const_env_actions(train_dir, distributed=True)
            for case, extra in RUNNER_CASES.items():
                steps = 2 * world * ENVS_PER_RANK * ROLLOUT
                argv = BASE + extra + [f"--train_for_env_steps={steps}", f"--train_dir={train_dir}", f"--experiment={case}",
                                       "--jax_distributed=True"]
                runner, rec = _run(argv)
                out[case] = {**rec.first, "final_params": _params(runner.train_state.model), "iterations": rec.iterations}
            out["population"] = {regime: _population_case(rank, train_dir, regime) for regime in ("sync", "async")}
            out["learner"] = _learner_cases(make_mesh(default_cfg(env="e", argv=["--device=cpu"])))
            try:
                make_rl_runner(_parse(BASE + [f"--train_dir={train_dir}", "--experiment=tp", "--jax_distributed=True", "--mesh_model=2"]),
                               register_fn=register_tiny_envs)
            except NotImplementedError as e:
                out["mesh_model_refused"] = str(e)
        else:
            out["const_actions"] = _const_env_actions(train_dir, distributed=True)
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
    out_dir = tmp_path_factory.mktemp("dp_host")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    ports = {2: _free_port(), 1: _free_port()}
    procs = {}
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        code = (f"import sys; sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_multihost_hostenv as t; "
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


def _join(trajectories):
    """Time-major trajectories joined on the env axis, in the order given."""
    first = trajectories[0]
    return {k: _join([t[k] for t in trajectories]) if isinstance(v, dict) else torch.cat([t[k] for t in trajectories], dim=1)
            for k, v in first.items()}


def _cfg_of(first_calls):
    from sample_factory_tpu_torch.utils.attr_dict import AttrDict

    return AttrDict(first_calls[0]["cfg"])


def _one_rank(first_calls):
    """One rank without a group, handed the ranks' first trajectories joined on the env axis in
    rank order, from the state the ranks started from: (train state, stats, joined trajectory,
    the quantized learner's epoch losses)."""
    cfg, info = _cfg_of(first_calls), first_calls[0]["env_info"]
    joined = _join([f["traj"] for f in first_calls])
    ts = _train_state(cfg, info, first_calls[0]["before"])
    stats, losses = _train_call(cfg, info, ts, joined)
    return ts, _floats(stats), joined, losses


# ------------------------------------------------------------------ the counterparts of tests/test_multihost_hostenv.py


def test_local_samplers_decorrelated(dp):
    r0, r1 = (r["host"] for r in _ranks(dp))
    assert r0["env_seed_offset"] == 0 and r1["env_seed_offset"] == 1000003
    assert not torch.equal(r0["first_obs"], r1["first_obs"]), "the ranks sampled identical episodes"


def test_one_global_train_step(dp):
    """Every rank's learner consumed both ranks' rows: the losses are equal on every rank, and
    env steps count both ranks' experience."""
    r0, r1 = (r["host"] for r in _ranks(dp))
    assert r0["type"] == "HostEnvRunner" and len(r0["losses"]) == SYNC_ITERATIONS
    assert r0["losses"] == r1["losses"]
    assert r0["env_steps"] == r1["env_steps"] == SYNC_ITERATIONS * 2 * ENVS_PER_RANK * ROLLOUT


def test_episode_stats_globally_aggregated(dp):
    """Both ranks' windows hold the global episode sums, every iteration's (the last one read at
    the end): each rank's total is the two ranks' local counts added up (P2)."""
    r0, r1 = (r["host"] for r in _ranks(dp))
    total = sum(r0["local_episodes"]) + sum(r1["local_episodes"])
    assert sum(r0["local_episodes"]) > 0 and sum(r1["local_episodes"]) > 0
    assert r0["episodes"] == r1["episodes"] == total
    assert r0["rewards"] == r1["rewards"] and r0["avg_reward"] == r1["avg_reward"]


def test_only_primary_writes(dp):
    r0, r1 = (r["host"] for r in _ranks(dp))
    steps = SYNC_ITERATIONS * 2 * ENVS_PER_RANK * ROLLOUT
    assert r0["saves"] == [steps] and r1["saves"] == []  # the final save, on rank 0 alone
    assert r0["checkpoints"] == r1["checkpoints"] == [f"checkpoint_{SYNC_ITERATIONS * 2:012d}_{steps}.pth"]
    assert r0["writer_noop"] is False and r1["writer_noop"] is True and r0["done_file"]


def test_resume_takes_rank0s_state_where_a_rank_has_no_checkpoint(dp):
    """Rank 1's train_dir holds no checkpoint: it starts from rank 0's parameters, optimizer
    state, train step, learning rate and env steps all the same, stops with rank 0 on the
    env-step count, and rank 0 alone saves."""
    (r0, h0), (r1, _) = ((r["resume"], r["host"]) for r in _ranks(dp))
    steps, step = SYNC_ITERATIONS * 2 * ENVS_PER_RANK * ROLLOUT, SYNC_ITERATIONS * 2
    for r in (r0, r1):
        assert r["start_env_steps"] == steps and r["start_train_step"] == step and r["start_optimizer_state"] > 0
        assert all(torch.equal(v, h0["params"][k]) for k, v in r["start_params"].items())
        assert r["iterations"] == 2 and r["env_steps"] == steps + 2 * 2 * ENVS_PER_RANK * ROLLOUT and r["train_step"] == step + 4
    assert r0["start_curr_lr"] == r1["start_curr_lr"]
    assert all(torch.equal(v, r0["params"][k]) for k, v in r1["params"].items())
    assert r0["saves"] == [r0["env_steps"]] and r1["saves"] == []


@pytest.mark.parametrize("regime", ["sync", "async"])
def test_multi_policy_population_step(dp, regime):
    """HostMultiPolicyRunner under the group: per-policy losses equal on both ranks, the same
    global per-policy episode counts, rank 0's PBT objectives on both, identical replicas."""
    r0, r1 = (r["population"][regime] for r in _ranks(dp))
    assert r0["type"] == "HostMultiPolicyRunner" and len(r0["losses"]) == 3 and all(len(row) == 2 for row in r0["losses"])
    assert r0["losses"] == r1["losses"]
    assert r0["episodes"] == r1["episodes"] and sum(r0["episodes"]) == sum(r0["local_episodes"]) + sum(r1["local_episodes"])
    assert r0["objectives"] and r0["objectives"] == r1["objectives"] and r0["objectives"][0] == [0.0, 10.0]
    assert r0["hparams"] == r1["hparams"]
    for p0, p1 in zip(r0["params"], r1["params"]):
        assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ------------------------------------------------------------------ 2 ranks with their own samplers = 1 rank on the joined trajectories


def _first_calls(dp, case):
    if case == "sync_fused_contiguous":
        return [r["host"]["first"] for r in _ranks(dp)]
    if case in LEARNER_CASES:
        return [r["learner"][case] for r in _ranks(dp)]
    return [r[case] for r in _ranks(dp)]


@pytest.mark.parametrize("case", ["sync_fused_contiguous", *RUNNER_CASES, *LEARNER_CASES])
def test_two_ranks_equal_one_rank_on_the_joined_trajectories(dp, case):
    first_calls = _first_calls(dp, case)
    ts, want, joined, want_losses = _one_rank(first_calls)
    for got in first_calls:
        for name, value in _params(ts.model).items():
            np.testing.assert_allclose(got["after"][name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=name)
        assert got["train_step"] == ts.train_step and got["curr_lr"] == pytest.approx(ts.curr_lr, rel=1e-6)
        for key in ("loss", "policy_loss", "value_loss", "kl_divergence", "grad_norm", "adv_mean", "adv_std", "valids_fraction",
                    "epochs_executed", "version_diff_max", "ratio_min", "ratio_max"):
            np.testing.assert_allclose(got["stats"][key], want[key], atol=1e-5, rtol=1e-5, err_msg=key)
    a, b = (f["after"] for f in first_calls)
    assert all(torch.equal(a[k], b[k]) for k in a)  # the replicas stay identical
    epochs = want["epochs_executed"]
    if want_losses is not None:
        # the quantized learner's early-stop checks read global epoch losses: equal on both ranks and to one rank's
        r0_losses, r1_losses = (f["epoch_losses"] for f in first_calls)
        assert r0_losses == r1_losses and len(r0_losses) == epochs
        np.testing.assert_allclose(r0_losses, want_losses, atol=1e-5, rtol=1e-5)
    if case == "async_quantized_early_stop":
        assert epochs == 2 and ts.train_step == 2 * 2  # 2 minibatches in each of the 2 epochs that ran
    elif case == "vtrace_lagged":
        assert want["valids_fraction"] < 0.75  # rank 1's lagged envs are masked out
    else:
        assert epochs == int(first_calls[0]["cfg"]["num_epochs"])
    assert joined["rewards"].shape[1] == 2 * ENVS_PER_RANK


def test_replicas_identical_after_the_runs(dp):
    for case in RUNNER_CASES:
        r0, r1 = (r[case] for r in _ranks(dp))
        assert r0["iterations"] == r1["iterations"] == 2
        assert all(torch.equal(r0["final_params"][k], v) for k, v in r1["final_params"].items()), case
    r0, r1 = (r["host"]["params"] for r in _ranks(dp))
    assert all(torch.equal(r0[k], v) for k, v in r1.items())


def test_two_ranks_equal_jax(dp):
    """The JAX fused train call on the joined trajectory (one process, which is what GSPMD's
    data-parallel program computes), from the ranks' initial parameters, through the bridge."""
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

    first_calls = _first_calls(dp, "sync_fused_contiguous")
    joined = _join([f["traj"] for f in first_calls])
    start = _train_state(_cfg_of(first_calls), first_calls[0]["env_info"], first_calls[0]["before"])
    jcfg = jax_default_cfg(env="tiny_env", argv=[a for a in BASE if a not in ("--device=cpu", "--env=tiny_env")])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox((OBS_DIM,))}), action_space=JDiscrete(ACTIONS), num_agents=1,
                       is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2, OBS_DIM))})
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(start.model.state_dict(), start.model))
    jts = jts.replace(params=params, opt_state=tx.init(params))
    jtraj = _map(joined, lambda x: jnp.asarray(x.numpy()))
    jts2, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, jtraj, jax.random.PRNGKey(1))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), start.model)
    assert int(jts2.train_step) == first_calls[0]["train_step"] == 2
    for got in first_calls:
        for name, value in got["after"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


# ------------------------------------------------------------------ the shared minibatch selector


def _dataset(rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"valids": torch.rand(rows, generator=g), "obs": {"obs": torch.rand((rows, 3), generator=g)},
            "rnn_states": torch.rand((rows, 4), generator=g)}


def _todays_quantized_minibatches(dataset, batch_size, recurrence, shuffle, generator):
    """The quantized learner's selection before the selector was shared (its `_contiguous_minibatches`
    and `_shuffled_minibatches`), kept here as the reference."""
    size = dataset["valids"].shape[0]
    M, S, per_mb = size // batch_size, size // recurrence, batch_size // recurrence

    def tree(fn, x):
        return {k: tree(fn, v) for k, v in x.items()} if isinstance(x, dict) else fn(x)

    if not shuffle:
        return [tree(lambda x: x[i * batch_size : (i + 1) * batch_size], dataset) for i in range(M)]
    perm = torch.randperm(S, generator=generator)[: M * per_mb]

    def gather(x, sel):
        return x.reshape((S, recurrence) + tuple(x.shape[1:]))[sel].reshape((batch_size,) + tuple(x.shape[1:]))

    return [tree(lambda x: gather(x, perm[i * per_mb : (i + 1) * per_mb]), dataset) for i in range(M)]


@pytest.mark.parametrize("shuffle", [False, True], ids=["contiguous", "shuffled"])
def test_selector_without_a_group_gives_todays_rows(shuffle):
    dataset = _dataset(96)
    got = select_minibatches(dataset, 0, 1, 32, 4, shuffle, torch.Generator().manual_seed(3))
    want = _todays_quantized_minibatches(dataset, 32, 4, shuffle, torch.Generator().manual_seed(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g["valids"], w["valids"]) and torch.equal(g["obs"]["obs"], w["obs"]["obs"])
        assert torch.equal(g["rnn_states"], w["rnn_states"])


def test_selector_splits_each_global_minibatch_over_the_ranks():
    """Two ranks' selections, joined in rank order within each minibatch, are one rank's rows of
    the joined dataset: contiguous (minibatch 0 lies on rank 0 alone) and shuffled (segments kept)."""
    whole = _dataset(64)
    halves = [{k: ({n: x[r * 32 : (r + 1) * 32] for n, x in v.items()} if isinstance(v, dict) else v[r * 32 : (r + 1) * 32])
               for k, v in whole.items()} for r in range(2)]
    for shuffle in (False, True):
        want = select_minibatches(whole, 0, 1, 32, 4, shuffle, torch.Generator().manual_seed(7))
        parts = [select_minibatches(halves[r], r, 2, 32, 4, shuffle, torch.Generator().manual_seed(7)) for r in range(2)]
        for i, w in enumerate(want):
            got = torch.cat([parts[r][i]["rnn_states"] for r in range(2)])
            assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, w["rnn_states"].tolist())), (shuffle, i)
            if not shuffle:
                assert parts[1 - i][i]["valids"].shape[0] == 0  # the other rank holds no row of it


@pytest.mark.parametrize("shuffle", [False, True], ids=["contiguous", "shuffled"])
@pytest.mark.parametrize("world", [1, 2])
def test_selector_gives_each_minibatch_its_segments_initial_states(shuffle, world):
    """`init_rnn_states` holds one row a segment of 4 rows: every rank's selection of it is the first row of each
    segment of its selected rows, one and two ranks, contiguous and shuffled."""
    whole = _dataset(64)
    whole["init_rnn_states"] = whole["rnn_states"][::4].clone()
    local = 64 // world
    for r in range(world):
        mine = {k: ({n: x[r * local : (r + 1) * local] for n, x in v.items()} if isinstance(v, dict)
                    else v[r * local // 4 : (r + 1) * local // 4] if k == "init_rnn_states" else v[r * local : (r + 1) * local])
                for k, v in whole.items()}
        for mb in select_minibatches(mine, r, world, 32, 4, shuffle, torch.Generator().manual_seed(5)):
            assert mb["init_rnn_states"].shape[0] * 4 == mb["valids"].shape[0]
            assert torch.equal(mb["init_rnn_states"], mb["rnn_states"][::4])


def test_fused_and_quantized_give_the_same_update_under_a_group(dp):
    for r in _ranks(dp):
        fused, quantized = r["learner"]["fused_vs_quantized"]["fused"], r["learner"]["fused_vs_quantized"]["quantized"]
        assert fused["train_step"] == quantized["train_step"] == 3 * 4
        for k, v in fused["params"].items():
            assert torch.equal(quantized["params"][k], v), k
        assert fused["stats"] == quantized["stats"]


def test_launch_plan_takes_every_row_count_a_rank_can_hold():
    """Under shuffled minibatches a rank holds 0 to B segments of a minibatch; the GRU kernel is
    launched for 1 to B of them (0 never reaches it). Every such count gets a one-wave plan, at
    the `dp_host` chip phase's shape (B = 256 segments of 32, GRU-256, float32)."""
    from sample_factory_tpu_torch.ops import cuda_rnn

    for b in range(1, 257):
        plan = cuda_rnn.launch_plan("gru", 32, b, 256, torch.float32)
        assert plan.design == "cluster" and plan.grid // plan.cluster <= cuda_rnn.H100_SXM.clusters_at_once(plan.cluster), b
        assert plan.grid // plan.cluster * plan.rows >= b, b


# ------------------------------------------------------------------ P1, P2: the faults this slice met


def test_ranks_draw_their_own_actions(dp, tmp_path):
    """P1: on an env whose observations are constant, only the action draws tell envs apart. The
    two ranks' draws differ; rank 0's and a world of one's are today's, those of a run without a group."""
    r0, r1 = (r["const_actions"] for r in _ranks(dp))
    assert not torch.equal(r0, r1)
    register_tiny_envs()
    want = _const_env_actions(str(tmp_path), distributed=False)
    assert torch.equal(r0, want) and torch.equal(dp[(1, 0)]["const_actions"], want)


def test_stop_is_agreed_when_the_clocks_cross_on_different_iterations(dp):
    """Rank 1's clock crossed --train_for_seconds after its second iteration, rank 0's never: the
    stop went into iteration 3's all-reduce, was read in iteration 4's, and both ranks ran 4."""
    r0, r1 = (r["host"] for r in _ranks(dp))
    assert r0["iterations"] == r1["iterations"] == SYNC_ITERATIONS


def test_one_collective_an_iteration_outside_the_learner(dp):
    """The episode sums and the stop share one all-reduce an iteration; before the first
    iteration, the stop is agreed once."""
    for r in _ranks(dp):
        assert r["host"]["collectives"] == [1] * SYNC_ITERATIONS


# ------------------------------------------------------------------ a world of one, train.py


def test_world_of_one_equals_no_group_bit_for_bit(dp, tmp_path):
    got = dp[(1, 0)]["host"]
    register_tiny_envs()
    steps = SYNC_ITERATIONS * ENVS_PER_RANK * ROLLOUT
    runner, rec = _run(BASE + [f"--train_for_env_steps={steps}", "--train_for_seconds=3600", f"--train_dir={tmp_path}",
                               "--experiment=nogroup"])
    assert got["env_steps"] == runner.env_steps == steps and got["iterations"] == rec.iterations == SYNC_ITERATIONS
    for name, value in _params(runner.train_state.model).items():
        assert torch.equal(got["params"][name], value), name
    assert all(torch.equal(a, b) for a, b in zip(got["actions"], rec.actions))
    assert got["losses"] == rec.losses and got["episodes"] == runner.episode_stats.total_episodes
    assert got["rewards"] == list(runner.episode_stats.rewards)


def test_train_runs_the_host_runners_under_a_group_and_refuses_tensor_parallelism(dp):
    for r in _ranks(dp):
        assert r["host"]["type"] == "HostEnvRunner" and r["population"]["sync"]["type"] == "HostMultiPolicyRunner"
        assert "HostEnvRunner does not shard parameters over the 'model' axis, as the JAX package's does not" in r["mesh_model_refused"]


# ------------------------------------------------------------------ J1: the JAX side, pinned as it is


def test_jax_quantized_trainer_of_several_processes_trains_on_process_0s_rows_only():
    """J1: the JAX host runner builds its QuantizedTrainer with the process-local env count
    (`host_runner.py:143-144`) and hands it the global trajectory. Its minibatches keep the first
    N/2 envs' rows (`quantized_train.py:70-72`): the update does not change when the rewards of
    envs N/2..N do, and it runs half the fused step's sgd steps."""
    import jax
    import jax.numpy as jnp

    from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
    from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn
    from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
    from sample_factory_tpu.algo.quantized_train import QuantizedTrainer as JaxQuantizedTrainer
    from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
    from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo
    from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
    from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic

    n = 2 * ENVS_PER_RANK
    jcfg = jax_default_cfg(env="e", argv=["--use_rnn=False", "--encoder_mlp_layers", "16", f"--rollout={ROLLOUT}", "--batch_size=32",
                                          "--num_epochs=1", f"--num_envs={n}", "--normalize_returns=False", "--seed=0"])
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox((OBS_DIM,))}), action_space=JDiscrete(ACTIONS), num_agents=1,
                       is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2, OBS_DIM))})
    traj = _map(_crafted_trajectory(n, lagged=False, rnn_size=1), lambda x: x.numpy())

    def quantized(trajectory):
        q = JaxQuantizedTrainer(jcfg, jinfo, jmodel, tx, 0, num_envs=n // 2)  # the process-local count, as the runner passes it
        q.enqueue(jts, _map(trajectory, jnp.asarray), jax.random.PRNGKey(1))
        while q.dispatch_one():
            pass
        return q, q.flush()[0]

    q, base = quantized(traj)
    changed = dict(traj, rewards=traj["rewards"].copy())
    changed["rewards"][:, n // 2 :] += 5.0
    _, other = quantized(changed)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(base.params), jax.tree.leaves(other.params)))
    fused, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, _map(traj, jnp.asarray), jax.random.PRNGKey(1))
    assert q.sgd_steps_per_train * 2 == int(fused.train_step) == n * ROLLOUT // 32
    # the port's quantized learner, handed the same view under a group of 2, reads the global dataset instead
    assert QuantizedTrainer(_parse_port_cfg(n), _env_info(), 0, num_envs=n // 2, mesh=_two_rank_mesh()).sgd_steps_per_train == int(fused.train_step)


def _parse_port_cfg(n):
    return default_cfg(env="e", argv=["--device=cpu", "--use_rnn=False", "--encoder_mlp_layers", "16", f"--rollout={ROLLOUT}",
                                      "--batch_size=32", "--num_epochs=1", f"--num_envs={n}", "--seed=0"])


def _two_rank_mesh():
    from sample_factory_tpu_torch.parallel.mesh import Mesh

    return Mesh(world=2, rank=0, data=2, model=1, device=torch.device("cpu"), distributed=True)
