"""The DMLab example (`examples/dmlab/`) against the JAX package's (`sf_examples_tpu/dmlab/`).

- A counterpart of each test of `tests/test_dmlab_integration.py`, named after it, on the port's
  modules (tokenization, the reward clip, specs and task assignment, the level cache, the
  encoder, DMLab-30 scoring, the level table).
- `DmlabEnv` of both packages over the stand-in engine `tests/standins/deepmind_lab.py` (neither
  machine has DeepMind Lab) on three dmlab_30 tasks, one through the level cache: the same
  observations, token ids, rewards, dones and infos for 200 steps, and the same seeds and maps in
  the cache.
- `DmlabEncoder` through the bridge (float32 1e-5, bfloat16 0.03) on an empty instruction, a full
  one of 16 tokens and tokens past the first padding; the JAX class refuses the learner's
  [S, R, 16] tokens (a fault of the JAX side, not copied), so the learner-shaped comparisons hold
  the port against the JAX encoder applied to the flattened batch.
- One learner update under `dmlab_params` (LSTM) at 1e-5, a JAX checkpoint restored in the port.
- `train_dmlab.main` over the stand-in engine through worker processes with the DMLab-30 score
  tracker registered, then `enjoy_dmlab.main`.
"""

import glob
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.context import global_model_factory as jax_global_model_factory  # noqa: E402
from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context  # noqa: E402
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs import spaces as jax_spaces  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.runner.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from sf_examples_tpu.dmlab import dmlab30 as jax_dmlab30  # noqa: E402
from sf_examples_tpu.dmlab import dmlab_env as jax_dmlab_env  # noqa: E402
from sf_examples_tpu.dmlab import dmlab_model as jax_dmlab_model  # noqa: E402
from sf_examples_tpu.dmlab.train_dmlab import parse_dmlab_args as jax_parse_dmlab_args  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.algo.sampling import normalize_obs  # noqa: E402
from sample_factory_tpu_torch.envs import spaces as torch_spaces  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.examples.custom_encoders import DmlabEncoder, InstructionEncoder  # noqa: E402
from sample_factory_tpu_torch.examples.dmlab import dmlab_env  # noqa: E402
from sample_factory_tpu_torch.examples.dmlab.dmlab30 import (  # noqa: E402
    DMLAB30,
    DMLAB30_LEVELS,
    DMLAB_MAX_INSTRUCTION_LEN,
    human_normalized_score,
)
from sample_factory_tpu_torch.examples.dmlab.dmlab_env import (  # noqa: E402
    DMLAB_ENVS,
    dmlab_env_by_name,
    optimistic_asymmetric_clip,
    string_to_hash_bucket,
    task_id_for_env,
    tokenize_instructions,
)
from sample_factory_tpu_torch.examples.dmlab.dmlab_level_cache import DmlabLevelCache  # noqa: E402
from sample_factory_tpu_torch.examples.dmlab.train_dmlab import parse_dmlab_args, register_dmlab_components  # noqa: E402
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402
from sample_factory_tpu_torch.runner.checkpoint import restore_from_jax_checkpoint  # noqa: E402
from sample_factory_tpu_torch.utils.attr_dict import AttrDict  # noqa: E402

torch.set_num_threads(1)

STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standins")  # deepmind_lab.py


@pytest.fixture(autouse=True)
def _fresh_contexts():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


@pytest.fixture()
def standin_engine(monkeypatch):
    """`import deepmind_lab` finds the stand-in, here and in spawned workers; each package's
    per-process level caches start empty."""
    monkeypatch.syspath_prepend(STANDIN_DIR)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([STANDIN_DIR, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.delitem(sys.modules, "deepmind_lab", raising=False)
    monkeypatch.setattr(jax_dmlab_env, "_LEVEL_CACHES", {})
    monkeypatch.setattr(dmlab_env, "_LEVEL_CACHES", {})
    yield
    sys.modules.pop("deepmind_lab", None)


# ---------------------------------------------------------------- counterparts of tests/test_dmlab_integration.py


def test_instruction_tokenization():
    t = tokenize_instructions("select the red object")
    assert t.shape == (DMLAB_MAX_INSTRUCTION_LEN,) and t.dtype == np.int32
    assert (t[:4] > 0).all() and (t[4:] == 0).all()
    # deterministic + in vocab range [1, vocab-1] (0 reserved for padding)
    t2 = tokenize_instructions("select the red object")
    assert (t == t2).all()
    assert 1 <= string_to_hash_bucket("watermaze", 1000) <= 999
    # truncation at max length
    long = tokenize_instructions(" ".join(["word"] * 40))
    assert (long > 0).all()
    assert tokenize_instructions(None).sum() == 0
    # the JAX package's token ids, word for word
    for text in ("select the red object", " ".join(f"w{i}" for i in range(20)), "", None):
        np.testing.assert_array_equal(tokenize_instructions(text), jax_dmlab_env.tokenize_instructions(text))


def test_optimistic_asymmetric_clip():
    # positive rewards: pure tanh squeeze re-scaled by 5
    assert optimistic_asymmetric_clip(1.0) == pytest.approx(5 * math.tanh(0.2))
    # negative rewards attenuated 0.3x
    assert optimistic_asymmetric_clip(-1.0) == pytest.approx(5 * 0.3 * math.tanh(-0.2))
    assert optimistic_asymmetric_clip(0.0) == 0.0
    # saturates near +/-5 (and 1.5 for the negative branch)
    assert optimistic_asymmetric_clip(1000.0) == pytest.approx(5.0, abs=1e-3)
    assert optimistic_asymmetric_clip(-1000.0) == pytest.approx(-1.5, abs=1e-3)


def test_env_specs_and_task_assignment():
    names = [s.name for s in DMLAB_ENVS]
    assert "dmlab_30" in names and "dmlab_benchmark" in names
    assert len(dmlab_env_by_name("dmlab_30").levels) == 30
    # fallback: raw level name
    spec = dmlab_env_by_name("dmlab_rooms_watermaze")
    assert spec.levels == ["contributed/dmlab30/rooms_watermaze"]

    cfg = AttrDict(dmlab_one_task_per_worker=False)
    spec30 = dmlab_env_by_name("dmlab_30")
    ids = [task_id_for_env(spec30, {"env_id": i, "worker_index": 0}, cfg) for i in range(60)]
    assert sorted(set(ids)) == list(range(30))  # round-robin covers all tasks
    cfg.dmlab_one_task_per_worker = True
    assert task_id_for_env(spec30, {"env_id": 5, "worker_index": 17}, cfg) == 17


def test_level_cache_seed_allocation(tmp_path):
    cache_dir, exp_dir = str(tmp_path / "cache"), str(tmp_path / "exp")
    os.makedirs(cache_dir)
    level = "contributed/dmlab30/rooms_keys_doors_puzzle"
    # pre-generate 3 seeds
    with open(os.path.join(cache_dir, f"{level.replace('/', '_')}.seeds"), "w") as f:
        for s, k in [(11, "k11"), (22, "k22"), (33, "k33")]:
            f.write(f"{s} {k}\n")

    cache = DmlabLevelCache(cache_dir, exp_dir, [level])
    got = {cache.get_unused_seed(level) for _ in range(3)}
    assert got == {11, 22, 33}, "pre-generated seeds must be consumed first, each exactly once"
    fresh = cache.get_unused_seed(level)
    assert fresh not in got, "after exhaustion, new random seeds must not repeat used ones"

    # resume: a new cache instance over the same experiment must skip all used seeds
    cache2 = DmlabLevelCache(cache_dir, exp_dir, [level])
    again = cache2.get_unused_seed(level)
    assert again not in got | {fresh}

    # pk3 store roundtrip via the env-facing hooks
    src = tmp_path / "map.pk3"
    src.write_bytes(b"pk3data")
    cache.write(level, fresh, "cachekey1", str(src))
    dst = tmp_path / "restored.pk3"
    assert cache.fetch("cachekey1", str(dst))
    assert dst.read_bytes() == b"pk3data"
    assert not cache.fetch("missing", str(dst))
    # the new seed was recorded as pre-generated for future experiments
    cache3 = DmlabLevelCache(cache_dir, str(tmp_path / "exp2"), [level])
    assert fresh in cache3.available[level]


def _claim_seeds(cache_dir, exp_dir, level, n, q):
    c = DmlabLevelCache(cache_dir, exp_dir, [level])
    q.put([c.get_unused_seed(level) for _ in range(n)])


def test_level_cache_concurrent_claims(tmp_path):
    """Two processes allocating from the same cache never claim the same seed."""
    import multiprocessing as mp

    cache_dir, exp_dir = str(tmp_path / "cache"), str(tmp_path / "exp")
    level = "lvl"

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_claim_seeds, args=(cache_dir, exp_dir, level, 20, q)) for _ in range(2)]
    for p in procs:
        p.start()
    results = [q.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    assert all(not p.is_alive() for p in procs)
    all_seeds = results[0] + results[1]
    assert len(all_seeds) == len(set(all_seeds)), "seed collision across processes"


def _dmlab_cfg(*extra):
    argv = ["--env=dmlab_30", "--experiment=dm_test", "--device=cpu"] + list(extra)
    return parse_dmlab_args(argv)


def test_dmlab_encoder_forward():
    from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec

    cfg = _dmlab_cfg()
    obs_space = make_dict_spec({"obs": Box((72, 96, 3)), "INSTR": Box((16,), 0, 1000, "int32")})
    register_dmlab_components()
    from sample_factory_tpu_torch.algo.context import global_model_factory

    from sample_factory_tpu_torch.models.model_utils import init_parameters_

    enc = init_parameters_(global_model_factory().encoder_factory(cfg, obs_space), torch.Generator().manual_seed(0))

    rng = np.random.default_rng(0)
    B = 4
    tokens = np.zeros((B, 16), np.int32)
    tokens[0, :3] = [5, 9, 2]
    tokens[1, :1] = [7]
    tokens[2] = rng.integers(1, 1000, 16)  # full-length
    # row 3: all padding (empty instruction)
    obs = {"obs": torch.tensor(rng.uniform(0, 1, (B, 72, 96, 3)), dtype=torch.float32), "INSTR": torch.tensor(tokens)}
    with torch.no_grad():
        out = enc(obs)
        out2 = enc(obs)
    assert out.shape == (B, 512 + 64)  # conv-mlp 512 + instruction LSTM 64
    assert bool(torch.isfinite(out).all())

    # different instructions -> different embeddings (image part identical)
    instr_part = out[:, 512:]
    assert not np.allclose(instr_part[0].numpy(), instr_part[1].numpy())
    # empty instruction contributes a deterministic (length-1-clamped) vector
    assert np.allclose(out.numpy(), out2.numpy())


def test_human_normalized_scoring():
    meta = DMLAB30["rooms_watermaze"]
    assert human_normalized_score("rooms_watermaze", meta.human) == pytest.approx(100.0)
    assert human_normalized_score("rooms_watermaze", meta.random) == pytest.approx(0.0)

    # end-to-end through the tracker with a fake runner/writer
    from sample_factory_tpu_torch.examples.dmlab.dmlab_summaries import TARGET_OBJECTIVE_STAT, Dmlab30ScoreTracker

    cfg = AttrDict(env="dmlab_watermaze", num_policies=1)
    tracker = Dmlab30ScoreTracker(cfg)
    runner = AttrDict(policy_avg_stats={})

    class FakeWriter:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, key, value, env_steps):
            self.scalars[key] = value

    writer = FakeWriter()
    # no data yet -> no summaries
    tracker.extra_summaries(runner, 0, writer, 1000)
    assert not writer.scalars

    raw = meta.random + 0.5 * (meta.human - meta.random)  # exactly 50%
    tracker.on_episode_extra_stats(runner, {"z_00_rooms_watermaze_dmlab_raw_score": raw}, 0)
    tracker.extra_summaries(runner, 0, writer, 2000)
    assert writer.scalars["_dmlab/000_mean_human_norm_score"] == pytest.approx(50.0)
    assert writer.scalars["_dmlab/000_capped_mean_human_norm_score"] == pytest.approx(50.0)
    assert runner.policy_avg_stats[TARGET_OBJECTIVE_STAT][0][-1] == pytest.approx(50.0)
    # accumulators flushed after reporting (IMPALA procedure)
    assert tracker.new_level_returns[0] == {}

    # capping: above-human performance caps at 100 but the uncapped mean doesn't
    tracker.on_episode_extra_stats(runner, {"z_00_rooms_watermaze_dmlab_raw_score": meta.human * 2}, 0)
    tracker.extra_summaries(runner, 0, writer, 3000)
    assert writer.scalars["_dmlab/000_capped_mean_human_norm_score"] == pytest.approx(100.0)
    assert writer.scalars["_dmlab/000_mean_human_norm_score"] > 100.0


def test_dmlab30_table_consistency():
    assert len(DMLAB30_LEVELS) == 30
    for name, meta in DMLAB30.items():
        assert meta.human > meta.random, name
        assert meta.episode_len > 0


# ---------------------------------------------------------------- the port against the JAX package


def test_tables_specs_and_params_match_jax():
    assert DMLAB30 == jax_dmlab30.DMLAB30 and DMLAB30_LEVELS == jax_dmlab30.DMLAB30_LEVELS
    assert [(s.name, s.levels, s.extra_cfg) for s in DMLAB_ENVS] == [(s.name, s.levels, s.extra_cfg) for s in jax_dmlab_env.DMLAB_ENVS]
    assert dmlab_env.ACTION_SET == jax_dmlab_env.ACTION_SET and dmlab_env.EXTENDED_ACTION_SET == jax_dmlab_env.EXTENDED_ACTION_SET
    argv = ["--env=dmlab_30", "--experiment=e"]
    jcfg, tcfg = jax_parse_dmlab_args(argv), parse_dmlab_args(argv + ["--device=cpu"])
    for key in ("encoder_conv_architecture", "obs_subtract_mean", "obs_scale", "env_frameskip", "nonlinearity", "rollout", "recurrence",
                "rnn_type", "rnn_size", "use_rnn", "num_epochs", "batched_sampling", "normalize_input_keys", "res_w", "res_h",
                "dmlab_throughput_benchmark", "dmlab_renderer", "dmlab30_dataset", "dmlab_with_instructions", "dmlab_extended_action_set",
                "dmlab_use_level_cache", "dmlab_one_task_per_worker", "batch_size", "compute_dtype"):
        assert tcfg[key] == jcfg[key], key
    assert (tcfg.rnn_type, tcfg.rnn_size, tcfg.normalize_input_keys) == ("lstm", 256, ["obs"])


def _env_cfg(parse, tmp_path, name):
    return parse(["--env=dmlab_30", f"--experiment={name}", f"--train_dir={tmp_path}", f"--dmlab_level_cache_path={tmp_path}/{name}_cache"]
                 + (["--device=cpu"] if parse is parse_dmlab_args else []))


@pytest.mark.parametrize("level", ["rooms_watermaze", "language_select_described_object", "rooms_keys_doors_puzzle"])
def test_dmlab_env_matches_jax_over_the_standin_engine(standin_engine, tmp_path, level):
    """make_dmlab_env of both packages on the dmlab_30 task of this env id (the third through the
    level cache, each package with its own cache and experiment): 200 steps of one action
    sequence give the same observations and token ids, clipped rewards, dones and infos (raw-score
    extra stats at each episode end), and both caches hold the same seeds and maps after it."""
    env_id = DMLAB30_LEVELS.index(level)
    jenv = jax_dmlab_env.make_dmlab_env("dmlab_30", _env_cfg(jax_parse_dmlab_args, tmp_path, "jax"), {"env_id": env_id, "worker_index": 0})
    tenv = dmlab_env.make_dmlab_env("dmlab_30", _env_cfg(parse_dmlab_args, tmp_path, "port"), AttrDict(env_id=env_id, worker_index=0))
    cached = level in dmlab_env.DMLAB30_LEVELS_THAT_USE_LEVEL_CACHE
    assert (tenv.level_cache is not None) == (jenv.level_cache is not None) == cached
    assert tenv.observation_space == torch_spaces.make_dict_spec(
        {"obs": torch_spaces.Box((72, 96, 3), 0.0, 255.0, "uint8"), "INSTR": torch_spaces.Box((16,), 0.0, 1000.0, "int32")})
    assert repr(tenv.observation_space) == repr(jax_spaces.from_gym_space(jenv.observation_space)).replace("sample_factory_tpu.", "")
    assert tenv.action_space == torch_spaces.Discrete(9) and jenv.action_space.n == 9
    (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
    rng = np.random.default_rng(env_id)
    ends, instructions = 0, set()
    try:
        for step in range(200):
            for key in ("obs", "INSTR"):
                np.testing.assert_array_equal(tobs[key], jobs[key], err_msg=f"step {step} {key}")
                assert tobs[key].dtype == jobs[key].dtype
            instructions.add(int((tobs["INSTR"] != 0).sum()))
            action = int(rng.integers(9))
            jout, tout = jenv.step(action), tenv.step(action)
            jobs, tobs = jout[0], tout[0]
            assert tout[1:4] == jout[1:4] and tout[4] == jout[4], f"step {step}"
            if tout[2]:
                ends += 1
                assert tout[4]["episode_extra_stats"][f"z_{env_id:02d}_{level}_len"] > 0
                (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
        assert ends >= 1 and len(instructions) > 1
        if cached:
            jdir, tdir = f"{tmp_path}/jax_cache", f"{tmp_path}/port_cache"
            name = f"contributed_dmlab30_{level}.seeds"
            with open(os.path.join(jdir, name)) as jf, open(os.path.join(tdir, name)) as tf:
                seeds = tf.read()
                assert seeds == jf.read() and len(seeds.splitlines()) == ends + 1
            assert sorted(os.listdir(os.path.join(tdir, "maps"))) == sorted(os.listdir(os.path.join(jdir, "maps")))
    finally:
        jenv.close()
        tenv.close()


# ---------------------------------------------------------------- the model through the bridge

OBS = (72, 96, 3)
NARROW = ["--rnn_size=32", "--encoder_conv_mlp_layers", "32", "--seed=0"]


class FlatBatchDmlabEncoder(jax_dmlab_model.DmlabEncoder):
    """The JAX DmlabEncoder applied to the batch flattened to [N, ...] and reshaped back: the JAX
    class unpacks the tokens' shape into (B, L), so the learner's [S, R, L] reaches it only so."""

    def __call__(self, obs_dict):
        lead = obs_dict["INSTR"].shape[:-1]
        out = super().__call__({k: v.reshape((-1,) + v.shape[len(lead):]) for k, v in obs_dict.items()})
        return out.reshape(lead + out.shape[-1:])


def _spaces(s):
    return s.make_dict_spec({"obs": s.Box(OBS, 0.0, 255.0, "uint8"), "INSTR": s.Box((16,), 0.0, 1000.0, "int32")}), s.Discrete(9)


def _models(dtype="float32", extra=()):
    argv = ["--env=dmlab_30", "--experiment=e", f"--compute_dtype={dtype}"] + NARROW + list(extra)
    jcfg, tcfg = jax_parse_dmlab_args(argv), parse_dmlab_args(argv + ["--device=cpu"])
    from sample_factory_tpu.models.model_utils import default_compute_dtype as jax_default_compute_dtype
    from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic

    jax_global_model_factory().register_encoder_factory(
        lambda cfg, space: FlatBatchDmlabEncoder(cfg, space, dtype=jax_default_compute_dtype(cfg)))
    register_dmlab_components()
    jspaces, tspaces = _spaces(jax_spaces), _spaces(torch_spaces)
    return jcfg, tcfg, jax_create_actor_critic(jcfg, *jspaces), create_actor_critic(tcfg, *tspaces), jspaces, tspaces


def _tokens(rng, lead):
    """Rows: empty, full (16), a short prefix, and tokens after a padding id."""
    t = rng.integers(1, 1000, lead + (16,)).astype(np.int32)
    flat = t.reshape(-1, 16)
    for i in range(flat.shape[0]):
        kind = i % 4
        if kind == 0:
            flat[i] = 0
        elif kind == 2:
            flat[i, 5:] = 0
        elif kind == 3:
            flat[i, 3] = 0
            flat[i, 9:] = 0
    return flat.reshape(t.shape)


def _obs(rng, lead):
    return {"obs": rng.uniform(0, 1, lead + OBS).astype(np.float32), "INSTR": _tokens(rng, lead)}


def test_jax_dmlab_encoder_refuses_the_learner_batch():
    """The JAX class unpacks `tokens.shape` into (B, L): the learner's [S, R, 16] tokens raise, so
    the JAX DMLab example cannot run a train call; the port's encoder takes any leading dims."""
    from sample_factory_tpu.utils.static_cfg import StaticConfig

    cfg = StaticConfig(jax_parse_dmlab_args(["--env=dmlab_30", "--experiment=e"] + NARROW))
    enc = jax_dmlab_model.make_dmlab_encoder(cfg, _spaces(jax_spaces)[0])
    rng = np.random.default_rng(0)
    params = enc.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _obs(rng, (4,))))
    with pytest.raises(ValueError, match="too many values to unpack"):
        enc.apply(params, jax.tree.map(jnp.asarray, _obs(rng, (2, 2))))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.03)])
def test_dmlab_encoder_matches_jax_through_the_bridge(dtype, tol):
    """DmlabEncoder inside the actor-critic (convnet_impala over 72x96x3, the instruction
    embedding and LSTM-64, the LSTM core): one flax parameter set carried in strictly (Embed_0 and
    FusedLSTMCell_0 among it); the instruction features, the head, logits, values and state of a
    rollout step ([B, 16] tokens: empty, full, prefix, tokens past a padding) and the head of a
    learner batch ([S, R, 16]) equal JAX's."""
    _, _, jmodel, tmodel, _, _ = _models(dtype)
    assert isinstance(tmodel.encoder, DmlabEncoder) and tmodel.encoder.get_out_size() == 32 + 64
    assert isinstance(tmodel.encoder.encoders["enc_instr"], InstructionEncoder)
    rng = np.random.default_rng(0)
    obs = _obs(rng, (8,))
    rnn = rng.normal(size=(8, 64)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, obs), jnp.asarray(rnn))
    instr = params["params"]["encoder"]["enc_instr"]
    assert instr["Embed_0"]["embedding"].shape == (1000, 20) and instr["FusedLSTMCell_0"]["wh"].shape == (64, 256)
    assert np.abs(np.asarray(instr["Embed_0"]["embedding"][0])).sum() > 0  # the padding row is a trained row
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    jhead = jmodel.apply(params, jax.tree.map(jnp.asarray, obs), method="forward_head")
    jlogits, jvalues, jstate = jmodel.apply(params, jax.tree.map(jnp.asarray, obs), jnp.asarray(rnn))
    batch = _obs(rng, (3, 4))
    jbatch = jmodel.apply(params, jax.tree.map(jnp.asarray, batch), method="forward_head")
    with torch.no_grad():
        tobs = {k: torch.tensor(v) for k, v in obs.items()}
        thead = tmodel.forward_head(tobs)
        tlogits, tvalues, tstate = tmodel(tobs, torch.tensor(rnn))
        tbatch = tmodel.forward_head({k: torch.tensor(v) for k, v in batch.items()})
    for got, want in ((thead, jhead), (tlogits, jlogits), (tvalues, jvalues), (tstate, jstate), (tbatch, jbatch)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)
    # an empty instruction reads the LSTM at step 0 (length clamped to 1); ids past a padding count
    with torch.no_grad():
        tokens = torch.tensor(obs["INSTR"])
        features = tmodel.encoder.encoders["enc_instr"](tokens)
        empty = tmodel.encoder.encoders["enc_instr"](torch.zeros((1, 16), dtype=torch.int32))
    assert torch.equal(features[0], empty[0]) and not torch.equal(features[0], features[1])


def test_bridge_round_trip_of_the_dmlab_model():
    """flax -> torch -> flax: every leaf comes back unchanged (the embedding table as it is, the
    instruction LSTM's wi/wh/bi in the JAX layout)."""
    _, _, jmodel, tmodel, _, _ = _models()
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, _obs(rng, (2,))), jnp.zeros((2, 64))))
    bridge.load_flax_params(tmodel, params)
    sd = tmodel.state_dict()
    assert torch.equal(sd["encoder.encoders.enc_instr.embed.0.weight"], torch.tensor(params["params"]["encoder"]["enc_instr"]["Embed_0"]["embedding"]))
    back = dict(jax.tree_util.tree_leaves_with_path(bridge.state_dict_to_flax(sd, tmodel)))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back) == len(sd)
    for path, value in flat:
        np.testing.assert_array_equal(back[path], value)


T, N = 8, 4


def test_one_update_under_dmlab_params_matches_jax():
    """One train call of each package from one parameter set on one trajectory with episode ends:
    dmlab_params (convnet_impala, LSTM over segments of 8, only `obs` normalized, the token ids
    passed through), 2 minibatches, 1 epoch. JAX runs its encoder on the flattened batch.
    Parameters, normalizers and the learning rate after it: 1e-5."""
    argv = [f"--rollout={T}", f"--recurrence={T}", f"--batch_size={T * N // 2}", f"--num_envs={N}"]
    jcfg, tcfg, jmodel, tmodel, jspaces, tspaces = _models(extra=argv)
    assert tcfg.normalize_input_keys == ["obs"] and tcfg.rnn_type == "lstm" and tcfg.num_epochs == 1
    jinfo = JaxEnvInfo(obs_space=jspaces[0], action_space=jspaces[1], num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=tspaces[0], action_space=tspaces[1], num_agents=1, is_device_env=False)
    tx = jax_make_optimizer(jcfg)
    sample = {"obs": jnp.zeros((2,) + OBS, jnp.uint8), "INSTR": jnp.zeros((2, 16), jnp.int32)}
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), sample)
    assert set(jts.obs_rms) == {"obs"}
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    assert set(tts.obs_rms) == {"obs"}

    rng = np.random.default_rng(0)
    traj = {
        "obs": {"obs": rng.integers(0, 256, (T + 1, N) + OBS).astype(np.uint8), "INSTR": _tokens(rng, (T + 1, N))},
        "rnn_states": rng.normal(size=(T + 1, N, 64)).astype(np.float32) * 0.5,
        "actions": rng.integers(0, 9, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, 9)).astype(np.float32) * 0.1,
        "log_prob_actions": np.log(rng.uniform(0.08, 0.15, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "time_outs": np.zeros((T, N), np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jts2, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 2 and np.isfinite(float(tstats["loss"]))
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(tts.obs_rms["obs"].running_mean.numpy(), np.asarray(jts2.obs_rms["obs"].running_mean), atol=1e-5)
    np.testing.assert_allclose(tts.obs_rms["obs"].running_var.numpy(), np.asarray(jts2.obs_rms["obs"].running_var), atol=1e-5)


def test_jax_checkpoint_of_the_dmlab_model_restores_in_the_port(tmp_path):
    """A JAX `.msgpack` of the example's train state (obs normalizer moved off its initial values)
    restores in the port: the same logits, values and LSTM state on the same frames and tokens, 1e-5."""
    from sample_factory_tpu.algo.running_mean_std import obs_rms_normalize as jax_obs_rms_normalize
    from sample_factory_tpu.algo.running_mean_std import obs_rms_update as jax_obs_rms_update
    from sample_factory_tpu.algo.sampling import _static_preprocess as jax_static_preprocess

    jcfg, tcfg, jmodel, tmodel, jspaces, tspaces = _models(extra=[f"--train_dir={tmp_path}"])
    jinfo = JaxEnvInfo(obs_space=jspaces[0], action_space=jspaces[1], num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=tspaces[0], action_space=tspaces[1], num_agents=1, is_device_env=False)
    rng = np.random.default_rng(2)
    frames = {"obs": rng.integers(0, 256, (8,) + OBS).astype(np.uint8), "INSTR": _tokens(rng, (8,))}
    jts = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, frames))
    pre = jax_static_preprocess(jcfg, jax.tree.map(jnp.asarray, frames))
    jts = jts.replace(obs_rms=jax_obs_rms_update(jts.obs_rms, {"obs": pre["obs"]}))
    path = jax_save_checkpoint(jcfg, 0, jts, 8192, 2.5)
    rnn = rng.normal(size=(8, 64)).astype(np.float32)
    jlogits, jvalues, jstate = jmodel.apply(jts.params, jax_obs_rms_normalize(jts.obs_rms, pre), jnp.asarray(rnn))

    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    assert restore_from_jax_checkpoint(tts, path)[0] == 8192
    with torch.no_grad():
        tlogits, tvalues, tstate = tts.model(normalize_obs(tcfg, tts.obs_rms, {k: torch.tensor(v) for k, v in frames.items()}),
                                             torch.tensor(rnn))
    for got, want in ((tlogits, jlogits), (tvalues, jvalues), (tstate, jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- the example end to end


def test_train_dmlab_through_worker_processes_then_enjoy(standin_engine, tmp_path, monkeypatch):
    """`train_dmlab.main` on dmlab_30 at dmlab_params (LSTM, the instruction encoder, the level
    cache in the run's directory) cut to 2 workers x 4 envs (8 of the 30 tasks), the DMLab-30
    score tracker registered as `main` registers it: it trains, the tracker receives each
    finished episode's raw score under its task, and a checkpoint is written; `enjoy_dmlab.main`
    plays it back."""
    from sample_factory_tpu_torch.examples.dmlab import dmlab_summaries, enjoy_dmlab, train_dmlab

    trackers = []

    class RecordingTracker(dmlab_summaries.Dmlab30ScoreTracker):
        def __init__(self, cfg):
            super().__init__(cfg)
            trackers.append(self)

    monkeypatch.setattr(dmlab_summaries, "Dmlab30ScoreTracker", RecordingTracker)
    argv = ["--env=dmlab_30", "--experiment=dm", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=2", "--num_envs_per_worker=4",
            "--worker_num_splits=2", "--rollout=16", "--recurrence=16", "--batch_size=64", "--train_for_env_steps=8192", "--rnn_size=32",
            "--encoder_conv_mlp_layers", "32", "--seed=0", "--decorrelate_envs_on_one_worker=False",
            f"--dmlab_level_cache_path={tmp_path}/cache"]
    assert train_dmlab.main(argv) == 0
    assert glob.glob(os.path.join(str(tmp_path), "dm", "checkpoint_p0", "checkpoint_*.pth"))
    (tracker,) = trackers
    seen = tracker.new_level_returns.get(0, {})
    assert seen and set(seen) <= {DMLAB30_LEVELS[i] for i in range(8)} and all(len(v) >= 1 for v in seen.values())
    assert enjoy_dmlab.main(argv + ["--no_render", "--max_num_episodes=2"]) == 0
