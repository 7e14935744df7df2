"""A checkpoint file of the JAX package, read by the port without flax or msgpack.

`bridge.unpack_msgpack` is held against `flax.serialization` on trees of every kind flax
writes; then a short JAX training run writes a real `.msgpack` checkpoint, the port loads it
(`bridge.load_jax_checkpoint`, `runner.checkpoint.restore_from_jax_checkpoint`) and gives the
same logits and values as the JAX model on the same observations: float32, 1e-5.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from sample_factory_tpu.algo.context import reset_global_context
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.algo.running_mean_std import obs_rms_normalize as jax_obs_rms_normalize
from sample_factory_tpu.algo.sampling import _static_preprocess as jax_static_preprocess
from sample_factory_tpu.envs.env_info import obtain_env_info as jax_obtain_env_info
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu.runner.checkpoint import load_checkpoint as jax_load_checkpoint
from sample_factory_tpu.train import run_rl as jax_run_rl
from sf_examples_tpu.train_synthetic import parse_custom_args as jax_parse_custom_args
from sf_examples_tpu.train_synthetic import register_synthetic_components as jax_register_synthetic_components
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn, normalize_obs
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import restore_from_jax_checkpoint

torch.set_num_threads(1)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).shape == np.asarray(want).shape, path
        np.testing.assert_array_equal(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), err_msg=path)
        if np.asarray(want).dtype.name != "bfloat16":  # the port reads bfloat16 as float32: numpy has no such type
            assert np.asarray(got).dtype == np.asarray(want).dtype, path
    else:
        assert got == want and type(got) is type(want), path


def test_unpack_msgpack_matches_flax_serialization():
    rng = np.random.default_rng(0)
    tree = {
        "ints": {"zero": 0, "small": 5, "neg": -3, "neg8": -100, "u8": 200, "u16": 40000, "u32": 3_000_000_000, "u64": 2**40,
                 "i16": -30000, "i32": -2_000_000_000, "i64": -(2**40)},
        "floats": {"f": 1.5, "tiny": -1e-300, "best": -1e9},
        "none": None, "yes": True, "no": False,
        "strings": {"short": "abc", "long": "x" * 300, "longer": "y" * 70000, "unicode": "épisode"},
        "k" * 40: {"nested": {"deeper": {"a": 1}}},
        "arrays": {
            "f32": rng.normal(size=(3, 4, 5)).astype(np.float32), "f64": rng.normal(size=(7,)), "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "u8": np.arange(256, dtype=np.uint8), "bool": np.asarray([True, False]), "scalar": np.asarray(3.5, np.float32),
            "empty": np.zeros((0, 4), np.float32), "big": rng.normal(size=(300, 300)).astype(np.float32),
            "bf16": np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)),
        },
        "np_scalars": {"f": np.float32(2.5), "i": np.int64(-7)},
        "many": {str(i): i for i in range(20)},
        "list": [1, "two", 3.0, None],
    }
    data = serialization.msgpack_serialize(tree)
    _assert_tree_equal(bridge.unpack_msgpack(data), serialization.msgpack_restore(data))
    assert bridge.unpack_msgpack(data)["arrays"]["bf16"].tolist() == [1.0, -2.5, 3.140625]
    with pytest.raises(ValueError, match="truncated"):
        bridge.unpack_msgpack(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        bridge.unpack_msgpack(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 2"):  # flax's native complex: no checkpoint holds one
        bridge.unpack_msgpack(serialization.msgpack_serialize({"z": 1 + 2j}))


CASES = {
    "gru": ["--env=synthetic_vector_discrete", "--use_rnn=True", "--rnn_size=16", "--recurrence=8", "--encoder_mlp_layers", "32",
            "--normalize_input=False"],
    "mlp_normalize_input": ["--env=synthetic_vector_discrete", "--use_rnn=False", "--normalize_input=True", "--normalize_returns=True",
                            "--encoder_mlp_layers", "32", "16"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_into_the_port(tmp_path, case):
    common = CASES[case] + ["--experiment=jax_run", f"--train_dir={tmp_path}", "--seed=2", "--device=cpu", "--num_workers=1",
                            "--num_envs_per_worker=8", "--rollout=8", "--batch_size=64", "--train_for_env_steps=640"]
    reset_global_context()
    jax_register_synthetic_components()
    jcfg = jax_parse_custom_args(common)
    assert jax_run_rl(jcfg) == 0
    (path,) = glob.glob(os.path.join(str(tmp_path), "jax_run", "checkpoint_p0", "checkpoint_*.msgpack"))

    # the JAX side's own view of the file
    jinfo = jax_obtain_env_info(jcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    rng = np.random.default_rng(0)
    obs = {"obs": rng.random((6, 8)).astype(np.float32)}
    rnn = (rng.normal(size=(6, 16 if case == "gru" else 1)) * 0.5).astype(np.float32)
    template = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(0), {"obs": jnp.asarray(obs["obs"][:2])})
    jts, jsteps, jbest = jax_load_checkpoint(jcfg, 0, template)
    jnorm = jax_static_preprocess(jcfg, {"obs": jnp.asarray(obs["obs"])})
    if jts.obs_rms is not None:
        jnorm = jax_obs_rms_normalize(jts.obs_rms, jnorm)
    jlogits, jvalues, jnew = jmodel.apply(jts.params, jnorm, jnp.asarray(rnn))
    reset_global_context()

    # the port: decode the file, map the parameters, restore a train state
    ckpt = bridge.load_jax_checkpoint(path)
    assert ckpt["train_step"] == int(jts.train_step) == 10 and ckpt["env_steps"] == jsteps == 640 and ckpt["best_performance"] == jbest
    assert ckpt["curr_lr"] == pytest.approx(float(jts.curr_lr)) and ckpt["hparams"]["gamma"] == pytest.approx(jcfg.gamma)
    register_synthetic_components()
    tcfg = parse_custom_args(common)
    tinfo = obtain_env_info(tcfg)
    tts = init_train_state(tcfg, tinfo, create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space), "cpu")
    assert restore_from_jax_checkpoint(tts, path) == (640, jbest)
    assert tts.train_step == 10 and tts.curr_lr == pytest.approx(float(jts.curr_lr))
    if case == "mlp_normalize_input":
        assert tcfg.normalize_input and tcfg.normalize_returns
        np.testing.assert_array_equal(tts.obs_rms["obs"].running_mean.numpy(), np.asarray(jts.obs_rms["obs"].running_mean))
        np.testing.assert_array_equal(tts.obs_rms["obs"].running_var.numpy(), np.asarray(jts.obs_rms["obs"].running_var))
        assert float(tts.obs_rms["obs"].count) == float(jts.obs_rms["obs"].count) > 1.0
        np.testing.assert_array_equal(tts.returns_rms.running_var.numpy(), np.asarray(jts.returns_rms.running_var))
    else:
        assert tts.obs_rms is None and ckpt["obs_rms"] is None
    with torch.no_grad():
        tlogits, tvalues, tnew = tts.model(normalize_obs(tcfg, tts.obs_rms, {"obs": torch.tensor(obs["obs"])}), torch.tensor(rnn))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=1e-5, rtol=0)
    # and the restored state trains on: a rollout and a train call of the port, with a fresh optimizer
    tenv_gen = torch.Generator().manual_seed(0)
    from sample_factory_tpu_torch.envs.env_utils import create_env

    env = create_env(tcfg.env, cfg=tcfg)
    ss = init_sampler_state(tcfg, env, 8, "cpu", tenv_gen)
    _, traj, _ = make_rollout_fn(tcfg, env, tinfo)(tts.model, tts.obs_rms, ss, tts.train_step, 0)
    stats = make_train_fn(tcfg, tinfo)(tts, traj, torch.Generator().manual_seed(1))
    assert tts.train_step == 11 and all(bool(torch.isfinite(v)) for v in stats.values())


def test_port_resumes_and_plays_back_a_jax_experiment(tmp_path):
    """An experiment directory whose only checkpoint the JAX package wrote: the port's `enjoy`
    plays it back and the port's trainer resumes from it (train step, env steps, parameters),
    then writes its own checkpoint beside it."""
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.train import make_rl_runner

    common = CASES["gru"] + ["--experiment=jax_run", f"--train_dir={tmp_path}", "--seed=2", "--device=cpu", "--num_workers=1",
                             "--num_envs_per_worker=8", "--rollout=8", "--batch_size=64", "--async_rl=False"]
    reset_global_context()
    jax_register_synthetic_components()
    assert jax_run_rl(jax_parse_custom_args(common + ["--train_for_env_steps=640"])) == 0
    reset_global_context()
    ckpt_dir = tmp_path / "jax_run" / "checkpoint_p0"
    (jax_file,) = [p.name for p in ckpt_dir.iterdir()]
    assert jax_file.endswith(".msgpack")

    register_synthetic_components()
    episodes = []
    status, avg_reward = enjoy(parse_custom_args(common + ["--no_render"], evaluation=True), num_episodes=4, num_envs=4,
                               collect_episodes=episodes)
    assert status == 0 and len(episodes) >= 4 and np.isfinite(avg_reward)

    cfg, runner = make_rl_runner(parse_custom_args(common + ["--train_for_env_steps=1280"]))
    runner.init()
    assert runner.env_steps == 640 and runner.train_state.train_step == 10
    want = bridge.flax_to_state_dict(bridge.load_jax_checkpoint(str(ckpt_dir / jax_file))["params"], runner.train_state.model)
    torch.testing.assert_close(runner.train_state.model.state_dict(), want, atol=0, rtol=0)
    assert runner.run() == 0
    assert runner.env_steps == 1280 and runner.train_state.train_step == 20
    assert sorted(p.suffix for p in ckpt_dir.iterdir()) == [".msgpack", ".pth"]
