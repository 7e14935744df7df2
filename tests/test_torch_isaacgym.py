"""The IsaacGym example (`examples/isaacgym_examples/`) against the JAX package's
(`sf_examples_tpu/isaacgym_examples/`), over stand-ins of `isaacgym`, `isaacgymenvs` and `hydra`
(`tests/standins/`; neither machine has them), with the stand-in sim on the CPU
(`ISAACGYM_STANDIN_DEVICE=cpu`).

- `ENV_CONFIGS` and the overrides, for all nine tasks.
- `IsaacGymBatchedEnv` of both packages: the same per-agent observations, rewards, terminations and
  truncations (`time_outs`) for one seeded action sequence; the spaces in the port's specs.
- The hydra finding: the JAX module's bare `initialize` refuses a second env in one process; the
  port's `with initialize(...)` builds any number.
- One learner update on the Ant configuration at 1e-5.
- `train_isaacgym.main` on Ant for 2 iterations, `enjoy_isaacgym.main` on its checkpoint, and one
  narrow AllegroHandLSTM iteration (the LSTM over the sim's states).
- The experiments module's command lines, and the import-order rule in fresh interpreters.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

gym = pytest.importorskip("gymnasium")

from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.envs.spaces import Box as JBox  # noqa: E402
from sample_factory_tpu.envs.spaces import make_dict_spec as jax_dict_spec  # noqa: E402
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic  # noqa: E402
from sf_examples_tpu.isaacgym_examples import train_isaacgym as jax_ig  # noqa: E402
from sf_examples_tpu.isaacgym_examples.experiments import isaacgym_basic_envs as jax_experiments  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import Box, from_gym_space, make_dict_spec  # noqa: E402
from sample_factory_tpu_torch.examples.isaacgym_examples import train_isaacgym as ig  # noqa: E402
from sample_factory_tpu_torch.examples.isaacgym_examples.experiments import isaacgym_basic_envs as experiments  # noqa: E402
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402

torch.set_num_threads(1)

STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standins")  # isaacgym/, isaacgymenvs/, hydra/
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN_PACKAGES = ("isaacgym", "isaacgymenvs", "hydra")


@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    yield
    reset_global_context()


@pytest.fixture()
def standin_sim(monkeypatch):
    """The stand-ins importable, the sim on the CPU. The stand-in `isaacgym` refuses a process that
    has imported torch, as the real one does; this process imported torch with the tests, so the
    stand-in is imported with torch out of `sys.modules` for the moment, as if it had come first."""
    monkeypatch.syspath_prepend(STANDIN_DIR)
    monkeypatch.setenv("ISAACGYM_STANDIN_DEVICE", "cpu")
    torch_module = sys.modules.pop("torch")
    try:
        import isaacgym  # noqa: F401
    finally:
        sys.modules["torch"] = torch_module
    yield
    for name in [n for n in sys.modules if n.split(".")[0] in STANDIN_PACKAGES]:
        del sys.modules[name]


def _cfgs(env, *extra):
    argv = [f"--env={env}", "--experiment=e", "--seed=1"] + list(extra)
    return jax_ig.parse_isaacgym_args(argv), ig.parse_isaacgym_args(argv + ["--device=cpu"])


def test_env_configs_and_overrides_match_jax():
    """The task list, `ENV_CONFIGS` value for value, the four flags, and every key of the parsed cfg
    of each of the nine tasks (the device's default apart)."""
    assert ig.ISAACGYM_ENVS == jax_ig.ISAACGYM_ENVS and len(ig.ISAACGYM_ENVS) == 9
    assert ig.ENV_CONFIGS == jax_ig.ENV_CONFIGS
    for env in ig.ISAACGYM_ENVS:
        jcfg, tcfg = _cfgs(env)
        own = ("device", "cli_args", "command_line")  # the port's runs here add --device=cpu
        assert {k: v for k, v in tcfg.items() if k not in own} == {k: v for k, v in jcfg.items() if k not in own}, env
        for key, value in ig.ENV_CONFIGS.get(env, {}).items():
            assert tcfg[key] == value, (env, key)
    jcfg, tcfg = _cfgs("AllegroHandLSTM")
    assert (tcfg.obs_key, tcfg.rnn_type, tcfg.rnn_size, tcfg.compute_dtype, tcfg.batch_size, tcfg.num_batches_per_epoch) == (
        "states", "lstm", 512, "float32", 32768, 8)
    assert (tcfg.serial_mode, tcfg.async_rl, tcfg.rollout, tcfg.env_agents, tcfg.subtask, tcfg.eval_stats) == (True, False, 16, -1, None, False)


@pytest.mark.parametrize("env,obs_width", [("Ant", 60), ("AllegroHandLSTM", 88)])
def test_batched_env_matches_jax_over_the_standin_sim(standin_sim, env, obs_width):
    """`make_isaacgym_env` of both packages at 64 sim agents: the same per-agent observations (the
    `states` for AllegroHandLSTM), rewards, terminations and truncations for 80 steps of one seeded
    action sequence, with both kinds of end among them; the port's spaces in its own specs equal
    what the JAX adapter's gymnasium spaces convert to."""
    from hydra.core.global_hydra import GlobalHydra

    jcfg, tcfg = _cfgs(env, "--env_agents=64")
    jenv = jax_ig.make_isaacgym_env(env, jcfg)
    GlobalHydra.instance().clear()  # the JAX module leaves hydra initialized
    tenv = ig.make_isaacgym_env(env, tcfg)
    assert not GlobalHydra.instance().is_initialized()
    assert tenv.num_agents == jenv.num_agents == 64 and tenv.is_multiagent
    assert tenv.observation_space == make_dict_spec({"obs": Box((obs_width,))}) == from_gym_space(jenv.observation_space)
    assert tenv.action_space == from_gym_space(jenv.action_space) and tenv.action_space.low == -1.0
    (tobs, tinfo), (jobs, jinfo) = tenv.reset(), jenv.reset()
    rng = np.random.default_rng(0)
    ends = {"terminated": 0, "truncated": 0}
    for step in range(80):
        assert len(tobs) == len(jobs) == 64 and tobs[0]["obs"].dtype == np.float32
        for a in range(64):
            np.testing.assert_array_equal(tobs[a]["obs"], jobs[a]["obs"], err_msg=f"step {step} agent {a}")
        actions = [rng.uniform(-1, 1, tenv.action_space.shape).astype(np.float32) for _ in range(64)]
        tout, jout = tenv.step(actions), jenv.step(actions)
        for i in (1, 2, 3):  # rewards, terminated, truncated
            np.testing.assert_array_equal(np.asarray(tout[i]), np.asarray(jout[i]), err_msg=f"step {step} item {i}")
        assert tout[4] == jout[4]
        tobs, jobs = tout[0], jout[0]
        ends["terminated"] += int(np.sum(np.asarray(tout[2]) & ~np.asarray(tout[3])))
        ends["truncated"] += int(np.sum(tout[3]))
    assert ends["terminated"] > 0 and ends["truncated"] > 0, ends


def test_jax_module_refuses_a_second_env_in_one_process(standin_sim, tmp_path, monkeypatch):
    """hydra keeps one global configuration and refuses a second `initialize`: the JAX module calls it
    bare (`train_isaacgym.py:126`), so its second env in a process raises. `--serial_mode` (the
    IsaacGym default) probes the env info inline and then builds the sampler's env, so the JAX
    example raises on a run without an env-info cache.
    The port initializes inside `with`, and builds env after env."""
    from hydra.core.global_hydra import GlobalHydra

    from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context
    from sample_factory_tpu.train import run_rl as jax_run_rl

    jcfg, tcfg = _cfgs("Cartpole", "--env_agents=8")
    try:
        jax_ig.make_isaacgym_env("Cartpole", jcfg)
        with pytest.raises(ValueError, match="GlobalHydra is already initialized"):
            jax_ig.make_isaacgym_env("Cartpole", jcfg)
        GlobalHydra.instance().clear()
        jax_reset_global_context()
        jax_ig.register_isaacgym_components()
        monkeypatch.setenv("HOME", str(tmp_path))  # the JAX package caches env info under ~; start without it
        run = jax_ig.parse_isaacgym_args(["--env=Cartpole", "--experiment=c", "--env_agents=8", f"--train_dir={tmp_path}",
                                          "--batch_size=16", "--train_for_env_steps=256", "--seed=1"])
        with pytest.raises(ValueError, match="GlobalHydra is already initialized"):
            jax_run_rl(run)
    finally:
        GlobalHydra.instance().clear()
        jax_reset_global_context()
    envs = [ig.make_isaacgym_env("Cartpole", tcfg) for _ in range(3)]
    assert [e.num_agents for e in envs] == [8, 8, 8] and not GlobalHydra.instance().is_initialized()


def test_isaacgym_env_raises_without_the_simulator(monkeypatch):
    """Without isaacgym the env raises on creation, as the JAX package's does; nothing falls back."""
    monkeypatch.setitem(sys.modules, "isaacgym", None)  # `import isaacgym` raises ImportError
    assert not ig.isaacgym_available()
    with pytest.raises(RuntimeError, match="isaacgym/isaacgymenvs are not installed"):
        ig.make_isaacgym_env("Ant", _cfgs("Ant")[1])


T, N, OBS, ACT = 16, 8, 60, 8


def test_one_update_under_the_ant_config_matches_jax():
    """One train call of each package from one parameter set under the Ant configuration (MLP
    256-128-64 elu, non-adaptive stddev, normalized inputs and returns, value bootstrap, the
    kl_adaptive_epoch schedule, 4 epochs of 2 minibatches, no gradient clip); the trajectory ends
    episodes by truncation and by termination. Parameters, normalizers and the learning rate: 1e-5."""
    argv = [f"--rollout={T}", f"--batch_size={T * N // 2}", f"--num_envs={N}"]
    jcfg, tcfg = _cfgs("Ant", *argv)
    assert (tcfg.lr_schedule, tcfg.num_epochs, tcfg.num_batches_per_epoch, tcfg.max_grad_norm, tcfg.nonlinearity) == (
        "kl_adaptive_epoch", 4, 2, 0.0, "elu")
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox((OBS,))}), action_space=JBox((ACT,), -1.0, 1.0), num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=make_dict_spec({"obs": Box((OBS,))}), action_space=Box((ACT,), -1.0, 1.0), num_agents=1, is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2, OBS))})
    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")

    rng = np.random.default_rng(0)
    ends = rng.random((T, N)) < 0.1
    time_outs = ends & (rng.random((T, N)) < 0.5)
    mean = rng.normal(size=(T, N, ACT)).astype(np.float32) * 0.3
    log_std = np.zeros((T, N, ACT), np.float32)
    actions = (mean + rng.normal(size=(T, N, ACT))).astype(np.float32)
    log_prob = (-0.5 * (actions - mean) ** 2 - 0.5 * np.log(2 * np.pi)).sum(-1)
    traj = {
        "obs": {"obs": (rng.normal(size=(T + 1, N, OBS)) * 2.0).astype(np.float32)},
        "rnn_states": np.zeros((T + 1, N, 1), np.float32),
        "actions": actions,
        "action_logits": np.concatenate([mean, log_std], -1),
        "log_prob_actions": log_prob.astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(1.0, 0.5, size=(T, N)).astype(np.float32),
        "dones": ends.astype(np.float32),
        "time_outs": time_outs.astype(np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    assert time_outs.sum() > 0 and (ends & ~time_outs).sum() > 0
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) and float(tstats["epochs_executed"]) == float(jstats["epochs_executed"])
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    jrms, trms = jts2.obs_rms["obs"], tts.obs_rms["obs"]
    np.testing.assert_allclose(trms.running_mean.numpy(), np.asarray(jrms.running_mean), atol=1e-5)
    np.testing.assert_allclose(trms.running_var.numpy(), np.asarray(jrms.running_var), atol=1e-5)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)


def test_train_ant_then_enjoy_and_an_allegro_lstm_iteration(standin_sim, tmp_path):
    """`train_isaacgym.main` on Ant at its configuration (serial mode, sync, 4 epochs of 2
    minibatches) cut to 64 sim agents for 2 iterations, then `enjoy_isaacgym.main` on its checkpoint
    (per-env resets never end all agents in one step, so it stops at --max_num_frames); then one
    iteration of AllegroHandLSTM at 64 agents with a narrow LSTM, its encoder over the 88 states."""
    from sample_factory_tpu_torch.examples.isaacgym_examples import enjoy_isaacgym

    base = ["--env_agents=64", f"--train_dir={tmp_path}", "--device=cpu", "--seed=1"]
    ant = ["--env=Ant", "--experiment=ant", "--batch_size=512", f"--train_for_env_steps={2 * 64 * 16}"] + base
    assert ig.main(ant) == 0
    assert enjoy_isaacgym.main(ant + ["--no_render", "--max_num_frames=32"]) == 0
    lstm = ["--env=AllegroHandLSTM", "--experiment=allegro", "--batch_size=128", "--rnn_size=32", f"--train_for_env_steps={64 * 16}"] + base
    assert ig.main(lstm) == 0
    (ckpt,) = [f for f in os.listdir(tmp_path / "allegro" / "checkpoint_p0") if f.startswith("checkpoint_")]
    model = torch.load(tmp_path / "allegro" / "checkpoint_p0" / ckpt, map_location="cpu", weights_only=True)["train_state"]["model"]
    assert any(k.startswith("encoder") and tuple(v.shape) == (512, 88) for k, v in model.items())  # the first Dense over the states
    assert [tuple(v.shape) for k, v in model.items() if k.endswith("wh")] == [(32, 128)]  # LSTM-32: wh [H, 4H]


def test_experiments_module_command_lines(tmp_path):
    """The launcher grid of both packages: the same experiments, the port's command naming the port's
    module."""
    tcmds = list(experiments.RUN_DESCRIPTION.generate_experiments(str(tmp_path), makedirs=False))
    jcmds = list(jax_experiments.RUN_DESCRIPTION.generate_experiments(str(tmp_path), makedirs=False))
    assert len(tcmds) == len(jcmds) == 6
    for (tcmd, tname, troot, _), (jcmd, jname, jroot, _) in zip(tcmds, jcmds):
        assert tcmd.startswith("python -m sample_factory_tpu_torch.examples.isaacgym_examples.train_isaacgym ")
        assert tcmd.replace("sample_factory_tpu_torch.examples.", "sf_examples_tpu.") == jcmd and (tname, troot) == (jname, jroot)


def test_isaacgym_is_imported_before_torch_in_a_fresh_interpreter():
    """The stand-in `isaacgym` refuses a process that has imported torch, as the real one does; the
    port's `train_isaacgym` (and `enjoy_isaacgym` through it) imports isaacgym before anything of the
    port, so importing it first in a fresh interpreter works, and the env builds."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([STANDIN_DIR, ROOT]), "ISAACGYM_STANDIN_DEVICE": "cpu"}
    refused = subprocess.run([sys.executable, "-c", "import torch\nimport isaacgym\n"], cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=120)
    assert refused.returncode != 0 and "PyTorch was imported before isaacgym modules" in refused.stderr
    code = ("import sys\n"
            "from sample_factory_tpu_torch.examples.isaacgym_examples import enjoy_isaacgym\n"
            "from sample_factory_tpu_torch.examples.isaacgym_examples import train_isaacgym as ig\n"
            "assert 'isaacgym' in sys.modules and 'torch' in sys.modules and ig.isaacgym_available()\n"
            "cfg = ig.parse_isaacgym_args(['--env=Ant', '--experiment=e', '--device=cpu', '--env_agents=4'])\n"
            "assert ig.make_isaacgym_env('Ant', cfg).num_agents == 4\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)
