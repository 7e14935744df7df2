"""The host-env sampler of the port against the JAX package's: the shared-memory queue and
slabs, the env stepper (exact: both are numpy), and `HostVectorSampler` in serial mode value
for value on the same env, seed and bridged parameters; then the worker processes over both
transports, and a killed worker.

Random draws are never matched by seed: actions are made deterministic by a spiked
action-head bias (as `tests/test_torch_population.py` does). The envs are the two packages'
copies of the vectorized numpy cart-pole, which fall and reset within a rollout under a
constant push. Tolerances are stated where they are used.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context
from sample_factory_tpu.algo.host_sampling import EnvSlotStepper as JaxEnvSlotStepper
from sample_factory_tpu.algo.host_sampling import HostVectorSampler as JaxHostVectorSampler
from sample_factory_tpu.algo.host_sampling import ShmSlabs as JaxShmSlabs
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.batched_host_env import register_batched_cartpole as jax_register_batched_cartpole
from sample_factory_tpu.envs.env_info import obtain_env_info as jax_obtain_env_info
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.algo.host_sampling import EnvSlotStepper, HostVectorSampler, ShmSlabs, _convert_host_action
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import TRAJECTORY_KEYS
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, TupleSpec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.native import shm_queue
from sample_factory_tpu_torch.native.shm_queue import QueueEmpty, QueueFull, ShmQueue

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


# ------------------------------------------------------------ the shared-memory queue


def test_queue_builds_into_the_build_directory_only():
    assert ShmQueue.available()
    path = shm_queue.library_path()
    assert path.is_file() and path.parent.name == "_build" and path.name.startswith("sf_shm_queue_")
    assert path.parent.parent.name == "sample_factory_tpu_torch"
    # nothing beside the source, and not the JAX package's library
    assert not list(shm_queue.SOURCE.parent.glob("*.so"))
    assert "sample_factory_tpu/native" not in str(path)


def test_queue_put_get_roundtrip():
    q = ShmQueue(capacity_bytes=1 << 16)
    try:
        q.put({"hello": [1, 2, 3]})
        q.put(("tuple", 42))
        assert q.get_many() == [{"hello": [1, 2, 3]}, ("tuple", 42)]
    finally:
        q.close()


def test_queue_get_empty_times_out():
    q = ShmQueue(capacity_bytes=1 << 12)
    try:
        t0 = time.time()
        with pytest.raises(QueueEmpty):
            q.get(timeout=0.2)
        assert 0.1 < time.time() - t0 < 2.0
    finally:
        q.close()


def test_queue_put_full_times_out():
    q = ShmQueue(capacity_bytes=1 << 10)
    try:
        with pytest.raises(QueueFull):
            for _ in range(10000):
                q.put(b"x" * 128, timeout=0.05)
    finally:
        q.close()


def test_queue_batched_put_many_get_many():
    q = ShmQueue(capacity_bytes=1 << 20)
    try:
        msgs = [{"i": i, "payload": "x" * i} for i in range(200)]
        q.put_many(msgs)
        assert q.qsize() == 200
        assert q.get_many(max_messages=1000) == msgs
        assert q.qsize() == 0
    finally:
        q.close()


def _producer(queue_name, n):
    q = ShmQueue(name=queue_name, create=False)
    for i in range(n):
        q.put(("msg", i))


def test_queue_cross_process():
    ctx = mp.get_context("spawn")
    q = ShmQueue(capacity_bytes=1 << 20)
    try:
        procs = [ctx.Process(target=_producer, args=(q.name, 50)) for _ in range(2)]
        for p in procs:
            p.start()
        received = []
        deadline = time.time() + 120
        while len(received) < 100 and time.time() < deadline:
            try:
                received.extend(q.get_many(timeout=1.0))
            except QueueEmpty:
                pass
        for p in procs:
            p.join(timeout=30)
        assert sorted(i for _, i in received) == sorted(list(range(50)) * 2)
    finally:
        q.close()


# ------------------------------------------------------------ slabs, actions, the stepper

BASE_ARGV = [
    "--num_workers=2", "--num_envs_per_worker=4", "--rollout=24", "--encoder_mlp_layers", "16", "--rnn_size=16",
    "--normalize_input=True", "--reward_scale=0.5", "--seed=3", "--decorrelate_envs_on_one_worker=False",
    "--batch_size=64", "--heartbeat_reporting_interval=5",
]


def _cfgs(extra, env="batched_cartpole"):
    argv = BASE_ARGV + list(extra)
    return jax_default_cfg(env=env, argv=argv + ["--device=cpu"]), default_cfg(env=env, argv=argv + ["--device=cpu"])


def _register_both():
    jax_register_batched_cartpole()
    register_batched_cartpole()


def test_shm_slabs_layout_and_attach():
    _register_both()
    _, tcfg = _cfgs(["--serial_mode=True", "--worker_num_splits=2"])
    info = obtain_env_info(tcfg)
    assert info.obs_space["obs"] == Box((4,), -np.inf, np.inf, "float32") and info.action_space == Discrete(2)
    slabs = ShmSlabs(tcfg, info, create=True)
    try:
        W, K, E = 2, 2, 2
        shapes = {k: (v.shape, v.dtype) for k, v in slabs.arrays.items()}
        assert shapes == {
            "obs_obs": ((W, K, E, 4), np.float32), "actions": ((W, K, E, 1), np.int32), "rewards": ((W, K, E), np.float32),
            "terminated": ((W, K, E), np.bool_), "truncated": ((W, K, E), np.bool_), "active": ((W, K, E), np.bool_),
        }
        other = ShmSlabs.attach(tcfg, info, slabs.attach_spec())
        slabs.arrays["obs_obs"][1, 0, 1] = [1.0, 2.0, 3.0, 4.0]
        other.arrays["actions"][0, 1, 0] = 7
        np.testing.assert_array_equal(other.arrays["obs_obs"][1, 0, 1], [1.0, 2.0, 3.0, 4.0])
        assert slabs.arrays["actions"][0, 1, 0, 0] == 7
        prefix = slabs.attach_spec()["prefix"]
        assert any(name.startswith(prefix) for name in os.listdir("/dev/shm"))
        other.close()
    finally:
        slabs.close(unlink=True)
    assert not any(name.startswith(prefix) for name in os.listdir("/dev/shm"))


def test_convert_host_action_takes_gymnasium_spaces_and_the_ports_specs():
    import gymnasium as gym

    a = np.asarray([2, 1], np.int32)
    for discrete, box, tup in (
        (gym.spaces.Discrete(3), gym.spaces.Box(-1, 1, (2,), np.float32),
         gym.spaces.Tuple((gym.spaces.Discrete(3), gym.spaces.Box(-1, 1, (2,), np.float32)))),
        (Discrete(3), Box((2,), -1, 1, "float32"), TupleSpec((Discrete(3), Box((2,), -1, 1, "float32")))),
    ):
        assert _convert_host_action(discrete, a[:1]) == 2
        out = _convert_host_action(box, np.asarray([0.5, -0.5]))
        assert out.dtype == np.float32 and out.tolist() == [0.5, -0.5]
        first, rest = _convert_host_action(tup, np.asarray([1.0, 0.25, -0.25], np.float32))
        assert first == 1 and rest.tolist() == [0.25, -0.25]


def _stepper_pair(jcfg, tcfg, jinfo, tinfo):
    jslabs, tslabs = JaxShmSlabs(jcfg, jinfo, create=True), ShmSlabs(tcfg, tinfo, create=True)
    jst, tst = JaxEnvSlotStepper(jcfg, jinfo, jslabs, 1), EnvSlotStepper(tcfg, tinfo, tslabs, 1)
    for st in (jst, tst):
        st.create_envs()
        st.reset_all()
    return jslabs, tslabs, jst, tst


def _assert_slabs_equal(jslabs, tslabs):
    assert set(jslabs.arrays) == set(tslabs.arrays)
    for k, v in jslabs.arrays.items():
        np.testing.assert_array_equal(tslabs.arrays[k], v, err_msg=k)


@pytest.mark.parametrize("env", ["batched_cartpole", "CartPole-v1"])
def test_env_slot_stepper_matches_jax_exactly(env):
    """Worker 1 of 2, two splits, 60 steps of the same drawn actions: every slab array and
    every completed episode (return, raw return, length) equal, exactly."""
    if env == "CartPole-v1":
        from sample_factory_tpu_torch.examples.train_gym_env import register_gym_env
        from sf_examples_tpu.train_gym_env import register_gym_env as jax_register_gym_env

        jax_register_gym_env(env)
        register_gym_env(env)
    else:
        _register_both()
    jcfg, tcfg = _cfgs(["--serial_mode=True", "--worker_num_splits=2"], env=env)
    jinfo, tinfo = jax_obtain_env_info(jcfg), obtain_env_info(tcfg)
    jslabs, tslabs, jst, tst = _stepper_pair(jcfg, tcfg, jinfo, tinfo)
    try:
        assert tst.batched == jst.batched == (env == "batched_cartpole")
        _assert_slabs_equal(jslabs, tslabs)
        rng = np.random.default_rng(0)
        episodes = 0
        for step in range(60):
            split = step % 2
            actions = rng.integers(0, 2, size=jslabs.arrays["actions"].shape).astype(np.int32)
            jslabs.arrays["actions"][:] = actions
            tslabs.arrays["actions"][:] = actions
            jdone, tdone = jst.step_split(split), tst.step_split(split)
            assert [d[:4] for d in tdone] == [tuple(d) for d in jdone]
            assert all(0 <= d[4] < 2 for d in tdone)  # the slot within the split, which the JAX tuples lack
            episodes += len(tdone)
            _assert_slabs_equal(jslabs, tslabs)
        assert episodes >= 4  # random pushes drop a pole in ~20 steps
        jst.close()
        tst.close()
    finally:
        jslabs.close(unlink=True)
        tslabs.close(unlink=True)


# ------------------------------------------------------------ the sampler, value for value


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bias_action(params, action_idx: int, scale: float = 50.0):
    """Parameters whose action head always emits `action_idx`: a spike in its bias."""

    def edit(path, leaf):
        names = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
        if any("action_parameterization" in n for n in names) and names[-1] == "bias":
            return jnp.zeros_like(leaf).at[action_idx].set(scale)
        return leaf

    return jax.tree_util.tree_map_with_path(edit, params)


def _policy_pair(jcfg, tcfg, jinfo, tinfo, action=1, key=0):
    """One flax parameter set with a spiked action head and a non-trivial obs normalizer,
    carried into a module of the port."""
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(key), {"obs": jnp.zeros((2, 4))})
    jts = jts.replace(params=_bias_action(jts.params, action))
    rng = np.random.default_rng(5 + key)
    mean, var = rng.uniform(-0.1, 0.1, 4).astype(np.float32), rng.uniform(0.5, 1.5, 4).astype(np.float32)
    jts = jts.replace(obs_rms={"obs": jts.obs_rms["obs"].replace(running_mean=jnp.asarray(mean), running_var=jnp.asarray(var))})
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, _np_tree(jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    tts.obs_rms = {"obs": replace(tts.obs_rms["obs"], running_mean=torch.tensor(mean), running_var=torch.tensor(var))}
    return jmodel, jts, tts


def _assert_traj_equal(ttraj, jtraj, atol=1e-5):
    """Every key of the trajectory: integers exactly, floats to `atol` (float32 sums of a
    narrow network in another order)."""
    assert set(ttraj) == set(jtraj) == set(TRAJECTORY_KEYS)
    for key in TRAJECTORY_KEYS:
        pairs = [(ttraj[key][k], jtraj[key][k], f"obs/{k}") for k in jtraj[key]] if key == "obs" else [(ttraj[key], jtraj[key], key)]
        for t, j, name in pairs:
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape, name
            assert str(t.dtype).split(".")[-1] == str(j.dtype), name
            if np.issubdtype(j.dtype, np.integer):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
            else:
                np.testing.assert_allclose(t.numpy(), j, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("use_rnn", [True, False])
def test_serial_sampler_matches_jax_value_for_value(use_rnn, splits):
    """Two rollouts in a row of 24 steps on 8 cart-poles under a constant push: poles fall
    after ~10 steps, so resets (and with an RNN the state's zeroing inside the step, and at
    the final flush) fall inside each rollout, and the second rollout starts from the carried
    state. Floats 1e-5, integers exact."""
    _register_both()
    jcfg, tcfg = _cfgs(["--serial_mode=True", f"--worker_num_splits={splits}", f"--use_rnn={use_rnn}"])
    jinfo, tinfo = jax_obtain_env_info(jcfg), obtain_env_info(tcfg)
    jmodel, jts, tts = _policy_pair(jcfg, tcfg, jinfo, tinfo)
    jsampler = JaxHostVectorSampler(jcfg, jinfo, jmodel)
    # With one split a slab's split is contiguous, `_split_obs` returns a view of it, and on the
    # CPU backend `jnp.asarray` shares that memory: the JAX trajectory's observations then change
    # under the env's next step. The test hands the JAX sampler copies; the JAX package stays as it is.
    jax_split_obs = jsampler._split_obs
    jsampler._split_obs = lambda split: {k: v.copy() for k, v in jax_split_obs(split).items()}
    tsampler = HostVectorSampler(tcfg, tinfo, "cpu")
    try:
        jsampler.start()
        tsampler.start()
        assert tsampler.transport == "serial" and tsampler.num_envs == jsampler.num_envs == 8
        for rollout, version in enumerate((7, 9)):
            jtraj, jstats = jsampler.collect_rollout(jts.params, jts.obs_rms, jax.random.PRNGKey(rollout), version, 0)
            ttraj, tstats = tsampler.collect_rollout(tts.model, tts.obs_rms, version, 0)
            _assert_traj_equal(ttraj, jtraj)
            T, N = 24, 8
            assert ttraj["obs"]["obs"].shape == (T + 1, N, 4) and ttraj["rnn_states"].shape[0] == T + 1
            assert (ttraj["actions"] == 1).all() and (ttraj["policy_version"] == version).all() and (ttraj["policy_id"] == 0).all()
            assert ttraj["dones"].sum() >= N  # every pole fell at least once
            assert set(ttraj["rewards"].unique().tolist()) == {0.5}  # reward 1 scaled by --reward_scale
            assert not ttraj["time_outs"].any()
            if use_rnn:
                # the stored state is the one the step consumed: zero right after a done
                after_done = ttraj["dones"][:-1] > 0
                assert ttraj["rnn_states"][1:T][after_done].abs().sum() == 0
                assert ttraj["rnn_states"][1:T][~after_done].abs().sum() > 0
                last_done = ttraj["dones"][-1] > 0
                assert ttraj["rnn_states"][T][last_done].abs().sum() == 0
            for k in ("count", "return_sum", "raw_return_sum", "len_sum"):
                assert tstats[k] == pytest.approx(jstats[k]), k
            assert tstats["count"] == ttraj["dones"].sum() == len(tstats["slots"]) == len(tstats["episodes"])
            # an episode's slot is the trajectory column in which its done fell
            done_columns = sorted(int(c) for c in torch.nonzero(ttraj["dones"])[:, 1])
            assert sorted(tstats["slots"]) == done_columns
    finally:
        jsampler.close()
        tsampler.close()


def test_trajectory_does_not_alias_the_slabs():
    """On the CPU `torch.from_numpy` would share memory with the slab, which the worker
    overwrites at its next step: the trajectory must hold copies."""
    _register_both()
    _, tcfg = _cfgs(["--serial_mode=True", "--worker_num_splits=2"])
    tinfo = obtain_env_info(tcfg)
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space, torch.Generator().manual_seed(0))
    sampler = HostVectorSampler(tcfg, tinfo, "cpu")
    try:
        sampler.start()
        traj, _ = sampler.collect_rollout(tmodel, None, 0, 0)
        before = {k: (v["obs"].clone() if k == "obs" else v.clone()) for k, v in traj.items()}
        for arr in sampler.slabs.arrays.values():
            arr[...] = 1 if arr.dtype == np.bool_ else 77
        traj2, _ = sampler.collect_rollout(tmodel, None, 1, 0)  # and a second rollout reuses no buffer of the first
        for k, v in before.items():
            torch.testing.assert_close(traj[k]["obs"] if k == "obs" else traj[k], v, rtol=0, atol=0)
        assert traj2["obs"]["obs"].data_ptr() != traj["obs"]["obs"].data_ptr()
    finally:
        sampler.close()


# ------------------------------------------------------------ worker processes


def _spiked_port_policy(tcfg, tinfo):
    model = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space, torch.Generator().manual_seed(0))
    with torch.no_grad():
        bias = model.action_parameterization.distribution_linear.bias
        bias.zero_()
        bias[1] = 50.0
    return model


def _collect(tcfg, tinfo, model, rollouts=2, **start):
    sampler = HostVectorSampler(tcfg, tinfo, "cpu", register_fn=register_batched_cartpole)
    try:
        sampler.start(**start)
        out = [sampler.collect_rollout(model, None, 3, 0) for _ in range(rollouts)]
        prefix = sampler.slabs.attach_spec()["prefix"]
        return sampler.transport, out, prefix, list(sampler.workers)
    finally:
        sampler.close()


@pytest.mark.parametrize("transport", ["shm_queue", "pipes"])
def test_worker_processes_give_the_serial_trajectory(transport):
    """Two spawned workers over each transport: with deterministic actions and envs the
    trajectories equal serial mode's exactly; the workers exit and no segment stays behind."""
    register_batched_cartpole()
    _, serial_cfg = _cfgs(["--serial_mode=True", "--worker_num_splits=2", "--use_rnn=True"])
    _, tcfg = _cfgs(["--serial_mode=False", "--worker_num_splits=2", "--use_rnn=True"])
    tinfo = obtain_env_info(serial_cfg)
    model = _spiked_port_policy(tcfg, tinfo)
    _, want, _, _ = _collect(serial_cfg, tinfo, model)
    used, got, prefix, workers = _collect(tcfg, tinfo, model, use_shm_queue=(transport == "shm_queue"))
    assert used == transport and len(workers) == 2
    for (gtraj, gstats), (wtraj, wstats) in zip(got, want):
        for key in TRAJECTORY_KEYS:
            torch.testing.assert_close(gtraj[key], wtraj[key], rtol=0, atol=0)
        assert gstats["count"] == wstats["count"] > 0 and gstats["return_sum"] == wstats["return_sum"]
        assert sorted(zip(gstats["slots"], gstats["episodes"])) == sorted(zip(wstats["slots"], wstats["episodes"]))
    assert all(not p.is_alive() for p in workers)
    assert not any(name.startswith(prefix) for name in os.listdir("/dev/shm"))


def test_killed_worker_raises_within_its_deadline():
    register_batched_cartpole()
    _, tcfg = _cfgs(["--serial_mode=False", "--worker_num_splits=2"])
    tinfo = obtain_env_info(tcfg, register_fn=register_batched_cartpole)  # probed in a spawned process
    assert not tinfo.is_device_env and tinfo.num_agents == 1
    model = _spiked_port_policy(tcfg, tinfo)
    sampler = HostVectorSampler(tcfg, tinfo, "cpu", register_fn=register_batched_cartpole)
    try:
        sampler.start()
        traj, _ = sampler.collect_rollout(model, None, 0, 0)
        assert traj["rewards"].shape == (24, 8)
        sampler.workers[0].kill()
        sampler.workers[0].join(timeout=5)
        t0 = time.time()
        with pytest.raises((TimeoutError, RuntimeError), match="worker 0 died|did not respond"):
            sampler.collect_rollout(model, None, 0, 0)
        assert time.time() - t0 < 15, "failure detection took too long"
    finally:
        sampler.close()
    assert all(not p.is_alive() for p in sampler.workers)


def test_worker_module_loads_neither_torch_nor_gymnasium():
    """A spawned worker imports `algo/host_worker.py` and what an env factory needs: for the
    numpy envs that is neither torch nor gymnasium."""
    code = (
        "import sys\n"
        "import sample_factory_tpu_torch.algo.host_worker, sample_factory_tpu_torch.envs.batched_host_env\n"
        "import sample_factory_tpu_torch.envs.env_info, sample_factory_tpu_torch.examples.train_custom_multi_env as game\n"
        "from sample_factory_tpu_torch.cfg.arguments import default_cfg\n"
        "from sample_factory_tpu_torch.envs.env_info import obtain_env_info\n"
        "game.register_custom_components()\n"
        "info = obtain_env_info(default_cfg(env=game.ENV_NAME, argv=['--serial_mode=True']))\n"
        "assert info.num_agents == 2 and not info.is_device_env\n"
        "print('LOADED', sorted(m for m in ('torch', 'gymnasium', 'jax') if m in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
