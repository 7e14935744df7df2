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
    assert (profile_dir / "trace.json").is_file()  # the profiler window closes with the run
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


def test_unported_branches_raise(tmp_path):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    with pytest.raises(NotImplementedError, match="A10"):
        make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + ["--num_policies=2"]))
    with pytest.raises(NotImplementedError, match="A13"):
        make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + ["--jax_distributed=True"]))
    with pytest.raises(NotImplementedError, match="A14"):
        make_rl_runner(parse_custom_args(_smoke_argv(tmp_path, 64) + ["--with_wandb=True"]))
    # the default regime (async) is ported: no flag needed
    cfg, runner = make_rl_runner(parse_custom_args([a for a in _smoke_argv(tmp_path, 64) if a != "--async_rl=False"]))
    assert cfg.async_rl and runner is not None
    with pytest.raises(SystemExit):  # argparse refuses the JAX package's platform
        parse_custom_args(_smoke_argv(tmp_path, 64) + ["--device=tpu"])


def test_port_imports_no_jax():
    """Import every module of the port and train with it in a fresh interpreter: no JAX module loads."""
    code = (
        "import sys, tempfile, pkgutil, importlib\n"
        "import sample_factory_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sample_factory_tpu_torch.__path__, 'sample_factory_tpu_torch.')]\n"
        "assert {'sample_factory_tpu_torch.enjoy', 'sample_factory_tpu_torch.eval', 'sample_factory_tpu_torch.envs.builtin.ant'} <= set(names)\n"
        "for name in names: importlib.import_module(name)\n"
        "from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components\n"
        "from sample_factory_tpu_torch.train import run_rl\n"
        "register_synthetic_components()\n"
        f"assert run_rl(parse_custom_args({_smoke_argv('TMP', 64)!r}[:-3] + ['--train_dir=' + tempfile.mkdtemp(), '--experiment=e', '--seed=1'])) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sample_factory_tpu'))\n"
        "print('FOREIGN', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout
