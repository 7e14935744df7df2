"""The port's export surfaces: the hand-built ONNX graph, the `torch.export` program, sampling.

- The eight cases of `tests/test_export_onnx.py`: the graph of `export_onnx.build_policy_onnx`,
  run by the port's numpy interpreter, against the port's `export_model.build_inference_fn`
  on the same arrays (atol 2e-4); the normalizers hold non-trivial moments.
- The JAX exporter and the port's, fed one set of flax parameters (through the bridge), run
  on the same arrays: equal actions, rnn state within 2e-4, the same graph inputs.
- The `.pt2` round trips of `tests/test_eval_export.py:69-85` on a run of the port: the
  reloaded program gives the live policy's actions; the ONNX file of the same run too.
- A sampling policy takes its draws as an input: actions in range, a categorical head's
  action frequencies within 3 sigma of its softmax over 4096 draws, a Gaussian head at the
  median draw gives its means.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.builtin import synthetic as jax_synthetic
from sample_factory_tpu.envs.env_info import extract_env_info as jax_extract_env_info
from sample_factory_tpu.export_onnx import build_policy_onnx as jax_build_policy_onnx
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.builtin import synthetic
from sample_factory_tpu_torch.envs.env_info import extract_env_info
from sample_factory_tpu_torch.envs.spaces import obs_space_as_dict
from sample_factory_tpu_torch.export_model import build_inference_fn, example_inputs, export_model, load_exported_model
from sample_factory_tpu_torch.export_onnx import build_policy_onnx, export_policy_onnx
from sample_factory_tpu_torch.models.actor_critic import actor_critic_rnn_state_size, create_actor_critic
from sample_factory_tpu_torch.onnx.interp import run_model

torch.set_num_threads(1)

ATOL = 2e-4

# the cases of tests/test_export_onnx.py:73-165: (env class name, constructor kwargs, argv)
ONNX_CASES = {
    "mlp_continuous_nonadaptive_tanh": ("SyntheticContinuousEnv", {"dim": 3}, [
        "--use_rnn=False", "--encoder_mlp_layers", "32", "16", "--adaptive_stddev=False", "--continuous_tanh_scale=2.0",
        "--normalize_input=True"]),
    "mlp_continuous_adaptive": ("SyntheticContinuousEnv", {"dim": 2}, ["--use_rnn=False", "--encoder_mlp_layers", "24",
                                                                        "--normalize_input=False"]),
    "conv_gru_discrete": ("SyntheticDiscreteEnv", {"num_actions": 6, "res": 24}, [
        "--use_rnn=True", "--rnn_type=gru", "--rnn_size=64", "--encoder_conv_architecture=convnet_impala",
        "--encoder_conv_mlp_layers", "48", "--normalize_input=True", "--obs_subtract_mean=0.5", "--obs_scale=1.5"]),
    "lstm_multilayer_decoder": ("SyntheticVectorDiscreteEnv", {"num_actions": 5, "dim": 12}, [
        "--use_rnn=True", "--rnn_type=lstm", "--rnn_num_layers=2", "--rnn_size=32", "--encoder_mlp_layers", "24",
        "--decoder_mlp_layers", "16", "--normalize_input=True"]),
    "separate_weights_gru": ("SyntheticVectorDiscreteEnv", {"num_actions": 4, "dim": 8}, [
        "--use_rnn=True", "--rnn_type=gru", "--rnn_size=24", "--actor_critic_share_weights=False", "--encoder_mlp_layers", "16",
        "--normalize_input=True"]),
    "action_mask": ("SyntheticMaskedEnv", {"num_actions": 6, "dim": 8}, ["--use_rnn=False", "--encoder_mlp_layers", "16",
                                                                       "--normalize_input=False"]),
    "file_roundtrip": ("SyntheticVectorDiscreteEnv", {"num_actions": 3, "dim": 4}, ["--use_rnn=False", "--encoder_mlp_layers", "8"]),
    "tuple_actions": ("SyntheticTupleActionEnv", {}, ["--use_rnn=False", "--encoder_mlp_layers", "16", "--normalize_input=True"]),
}


def _inputs(obs_spec, rnn_size, batch, rng):
    obs = {k: rng.normal(0.3, 1.1, size=(batch,) + tuple(s.shape)).astype(np.float32) for k, s in obs_spec.items()}
    if "action_mask" in obs:
        obs["action_mask"] = (rng.random(obs["action_mask"].shape) > 0.4).astype(np.float32)
        obs["action_mask"][:, 0] = 1.0  # at least one legal action
    rnn = rng.normal(0.1, 0.5, size=(batch, rnn_size)).astype(np.float32)
    return obs, rnn


def _port_setup(case, batch=3, seed=0):
    env_cls, kwargs, argv = ONNX_CASES[case]
    cfg = default_cfg(env="t", argv=argv + [f"--seed={seed}", "--device=cpu", "--eval_deterministic=True"])
    env_info = extract_env_info(getattr(synthetic, env_cls)(**kwargs), cfg)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(seed))
    ts = init_train_state(cfg, env_info, model, "cpu")
    rng = np.random.default_rng(seed)
    if ts.obs_rms is not None:  # moments a run would have gathered, so that the normalizer does work
        ts.obs_rms = {
            k: dataclasses.replace(v, running_mean=torch.tensor(rng.normal(0.2, 0.5, size=v.running_mean.shape), dtype=torch.float32),
                                   running_var=torch.tensor(rng.uniform(0.5, 2.0, size=v.running_var.shape), dtype=torch.float32))
            for k, v in ts.obs_rms.items()
        }
    obs, rnn = _inputs(obs_space_as_dict(env_info.obs_space), actor_critic_rnn_state_size(cfg), batch, rng)
    return cfg, env_info, ts, obs, rnn


def _run_onnx(blob, obs, rnn):
    outs = run_model(blob, {**obs, "rnn_state": rnn})
    actions, new_rnn = list(outs.values())
    return actions, new_rnn


@pytest.mark.parametrize("case", list(ONNX_CASES))
def test_onnx_graph_matches_the_port_policy(case):
    cfg, env_info, ts, obs, rnn = _port_setup(case)
    policy = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=True)
    with torch.no_grad():
        want_actions, want_rnn = policy({k: torch.tensor(v) for k, v in obs.items()}, torch.tensor(rnn))
    want_actions, want_rnn = want_actions.numpy(), want_rnn.numpy()

    blob = build_policy_onnx(cfg, env_info, ts, batch_size=rnn.shape[0])
    actions, new_rnn = _run_onnx(blob, obs, rnn)
    if want_actions.dtype == np.int32:
        np.testing.assert_array_equal(actions.reshape(want_actions.shape).astype(np.int32), want_actions)
    else:
        np.testing.assert_allclose(actions.reshape(want_actions.shape), want_actions, atol=ATOL)
    np.testing.assert_allclose(new_rnn, want_rnn, atol=ATOL)

    if case == "action_mask":  # masked actions are never selected
        assert all(obs["action_mask"][i, int(a)] == 1.0 for i, a in enumerate(actions.reshape(-1)))
    if case == "file_roundtrip":  # the serialized artifact parses back into a valid model
        from sample_factory_tpu_torch.onnx import onnx_pb2 as ox

        m = ox.ModelProto.FromString(blob)
        assert m.ir_version == 8 and m.opset_import[0].version == 17
        assert len(m.graph.node) > 0 and len(m.graph.initializer) > 0
        assert [vi.name for vi in m.graph.input] == ["obs", "rnn_state"] and len(m.graph.output) == 2


def test_jax_and_port_exporters_agree_on_one_set_of_parameters():
    """The pixel case (IMPALA conv, GRU, normalizer): the JAX graph from the flax tree and the
    port's from the port model that the bridge loaded with that tree."""
    _, kwargs, argv = ONNX_CASES["conv_gru_discrete"]
    jcfg = jax_default_cfg(env="t", argv=argv + ["--seed=0"])
    jinfo = jax_extract_env_info(jax_synthetic.SyntheticDiscreteEnv(**kwargs), jcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    rng = np.random.default_rng(1)
    obs, rnn = _inputs({"obs": jinfo.obs_space["obs"]}, jcfg.rnn_size, 5, rng)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(0), {"obs": jnp.asarray(obs["obs"][:2])})

    cfg = default_cfg(env="t", argv=argv + ["--seed=0", "--device=cpu"])
    env_info = extract_env_info(synthetic.SyntheticDiscreteEnv(**kwargs), cfg)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space)
    bridge.load_flax_params(model, jax.tree.map(np.asarray, jts.params))
    ts = init_train_state(cfg, env_info, model, "cpu")

    jblob, blob = jax_build_policy_onnx(jcfg, jinfo, jts, batch_size=5), build_policy_onnx(cfg, env_info, ts, batch_size=5)
    from sample_factory_tpu_torch.onnx import onnx_pb2 as ox

    inputs = [[(vi.name, [d.dim_value for d in vi.type.tensor_type.shape.dim]) for vi in ox.ModelProto.FromString(b).graph.input]
              for b in (jblob, blob)]
    assert inputs[0] == inputs[1] == [("obs", [5, 24, 24, 1]), ("rnn_state", [5, 64])]
    jactions, jrnn = _run_onnx(jblob, obs, rnn)
    actions, new_rnn = _run_onnx(blob, obs, rnn)
    np.testing.assert_array_equal(actions, jactions)
    np.testing.assert_allclose(new_rnn, jrnn, atol=ATOL)


@pytest.fixture(scope="module")
def trained_experiment(tmp_path_factory):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import run_rl

    reset_global_context()
    register_synthetic_components()
    tmp_path = tmp_path_factory.mktemp("torch_export")
    argv = ["--env=synthetic_vector_discrete", "--experiment=ee1", f"--train_dir={tmp_path}", "--seed=2", "--device=cpu",
            "--num_envs=16", "--rollout=16", "--batch_size=128", "--train_for_env_steps=512", "--encoder_mlp_layers", "32",
            "--use_rnn=True", "--rnn_size=16", "--recurrence=16", "--normalize_input=True", "--async_rl=False"]
    assert run_rl(parse_custom_args(argv)) == 0
    return tmp_path


def _eval_cfg(train_dir, *extra):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    return parse_custom_args(["--env=synthetic_vector_discrete", "--experiment=ee1", f"--train_dir={train_dir}", *extra], evaluation=True)


def _live_policy(cfg, deterministic=True):
    from sample_factory_tpu_torch.export_model import load_policy

    cfg, env_info, ts = load_policy(cfg)
    return build_inference_fn(cfg, env_info, ts.model, ts, deterministic=deterministic), cfg


def test_export_and_reload(trained_experiment):
    """tests/test_eval_export.py:69-85 through `.pt2`, then the reloaded program against the live
    policy over a rollout of states, and the ONNX file of the same run."""
    path = export_model(_eval_cfg(trained_experiment, "--eval_deterministic=True"), batch_size=4)
    assert path.endswith("policy_p0.pt2")
    exported = load_exported_model(path)
    obs = {"obs": torch.ones((4, 8)) * 0.5}
    rnn = torch.zeros((4, 16))
    with torch.no_grad():
        actions, new_rnn = exported(obs, rnn)
    assert actions.shape == (4, 1) and actions.dtype == torch.int32 and new_rnn.shape == (4, 16)
    assert 0 <= int(actions.min()) and int(actions.max()) < 10

    live, cfg = _live_policy(_eval_cfg(trained_experiment))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        rnn_live = rnn_exported = rnn
        for _ in range(8):  # each step feeds the program's own rnn state back
            obs = {"obs": torch.tensor(rng.normal(size=(4, 8)), dtype=torch.float32)}
            a_live, rnn_live = live(obs, rnn_live)
            a_exp, rnn_exported = exported(obs, rnn_exported)
            assert torch.equal(a_live, a_exp)
            torch.testing.assert_close(rnn_exported, rnn_live, atol=1e-6, rtol=0)

    if not torch.cuda.is_available():  # no fallback: --device=gpu without a card raises, as training does
        with pytest.raises(RuntimeError, match="--device=gpu"):
            export_model(_eval_cfg(trained_experiment, "--device=gpu"))

    onnx_path = export_policy_onnx(_eval_cfg(trained_experiment), batch_size=4)
    assert onnx_path.endswith("policy_p0.onnx")
    obs_np, rnn_np = rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=(4, 16)).astype(np.float32)
    with open(onnx_path, "rb") as f:
        actions, new_rnn = _run_onnx(f.read(), {"obs": obs_np}, rnn_np)
    with torch.no_grad():
        a_live, rnn_live = live({"obs": torch.tensor(obs_np)}, torch.tensor(rnn_np))
    np.testing.assert_array_equal(actions.astype(np.int32), a_live.numpy())
    np.testing.assert_allclose(new_rnn, rnn_live.numpy(), atol=ATOL)


def test_exported_sampling_policy(trained_experiment):
    """--eval_deterministic=False: the draws are the program's third input. Over 4096 copies of
    one state each action's frequency lies within 3 sigma of the policy's softmax."""
    from sample_factory_tpu_torch.algo.distributions import get_action_distribution
    from sample_factory_tpu_torch.algo.sampling import normalize_obs

    n = 4096
    path = export_model(_eval_cfg(trained_experiment, "--eval_deterministic=False"), batch_size=n)
    exported = load_exported_model(path)
    live, cfg = _live_policy(_eval_cfg(trained_experiment), deterministic=False)
    assert live.noise_width == 10  # one draw per category
    state = torch.tensor(np.random.default_rng(3).normal(size=(1, 8)), dtype=torch.float32)
    obs, rnn = {"obs": state.expand(n, 8).contiguous()}, torch.zeros((n, 16))
    noise = live.draw_noise(n, torch.Generator().manual_seed(5))
    with torch.no_grad():
        actions, _ = exported(obs, rnn, noise)
        assert torch.equal(actions, live(obs, rnn, noise)[0])
        logits, _, _ = live.model(normalize_obs(cfg, live.obs_rms, {"obs": state}), rnn[:1])
        probs = get_action_distribution(live.action_space, logits).probs[0].double().numpy()
    assert actions.shape == (n, 1) and 0 <= int(actions.min()) and int(actions.max()) < 10
    freq = np.bincount(actions[:, 0].numpy(), minlength=10) / n
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 3 * sigma + 1e-12), (freq, probs)


def test_gaussian_and_tuple_heads_take_their_draws_from_the_input():
    """At the median draw (0.5 everywhere) a sampling policy acts as the deterministic one: a
    Gaussian head gives its means (one draw a dimension), a categorical one its argmax (the
    same Gumbel offset on every logit); a tuple head splits its draws between the two."""
    for case, width in (("mlp_continuous_adaptive", 2), ("tuple_actions", None)):
        cfg, env_info, ts, obs, rnn = _port_setup(case, batch=6)
        policy = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=False)
        greedy = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=True)
        program = torch.export.export(policy, example_inputs(cfg, env_info, policy, 6, "cpu")).module()
        obs_t, rnn_t = {k: torch.tensor(v) for k, v in obs.items()}, torch.tensor(rnn)
        with torch.no_grad():
            want = greedy(obs_t, rnn_t)[0]
            torch.testing.assert_close(program(obs_t, rnn_t, torch.full((6, policy.noise_width), 0.5))[0], want)
            drawn = program(obs_t, rnn_t, torch.rand((6, policy.noise_width), generator=torch.Generator().manual_seed(0)))[0]
        assert bool(torch.isfinite(drawn).all()) and drawn.shape == want.shape and not torch.equal(drawn, want)
        if width is not None:
            assert policy.noise_width == width
