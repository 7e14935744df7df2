"""The two cells pinned to what the benchmark made of them before a configuration could name its own reference, its
observation keys and its encoder factory: the leaves' names and shapes, the weights drawn from one seed, the flops of a
forward and the least time of the recurrent work (numbers written here from that version's run), and the keys,
dtypes and shapes that a tiny run records; and the encoder factory that a configuration names, registered for the run
and the one found before restored after it."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from port_bench import flops, harness, reference, roofline
from port_bench.harness import run_cell
from port_bench.reference import learner as ref_learner
from port_bench.tests.tiny import tiny

ALLEGRO_LEAVES = [
    ("encoder.encoders.enc_obs.dense.0.weight", [512, 88]), ("encoder.encoders.enc_obs.dense.0.bias", [512]),
    ("encoder.encoders.enc_obs.dense.1.weight", [256, 512]), ("encoder.encoders.enc_obs.dense.1.bias", [256]),
    ("encoder.encoders.enc_obs.dense.2.weight", [128, 256]), ("encoder.encoders.enc_obs.dense.2.bias", [128]),
    ("core.lstm_0.wi", [128, 2048]), ("core.lstm_0.wh", [512, 2048]), ("core.lstm_0.bi", [2048]),
    ("critic_linear.weight", [1, 512]), ("critic_linear.bias", [1]),
    ("action_parameterization.distribution_linear.weight", [16, 512]),
    ("action_parameterization.distribution_linear.bias", [16]), ("action_parameterization.learned_stddev", [16])]
GRID_LEAVES = [
    ("encoder.encoders.enc_obs.conv.0.weight", [16, 3, 8, 8]), ("encoder.encoders.enc_obs.conv.0.bias", [16]),
    ("encoder.encoders.enc_obs.conv.1.weight", [32, 16, 4, 4]), ("encoder.encoders.enc_obs.conv.1.bias", [32]),
    ("encoder.encoders.enc_obs.dense.0.weight", [256, 32]), ("encoder.encoders.enc_obs.dense.0.bias", [256]),
    ("core.gru_0.wi", [256, 768]), ("core.gru_0.wh", [256, 768]), ("core.gru_0.bi", [768]), ("core.gru_0.bh", [768]),
    ("critic_linear.weight", [1, 256]), ("critic_linear.bias", [1]),
    ("action_parameterization.distribution_linear.weight", [6, 256]),
    ("action_parameterization.distribution_linear.bias", [6])]
ROOT = Path(__file__).resolve().parents[2]
SEED = 2147483901
PINNED = {  # as that version made them on the CPU, seed 2147483901
    "allegro_lstm512": {
        "leaves": ALLEGRO_LEAVES,
        "first_weights": [-0.13940419256687164, 0.06640888750553131, 0.05549273639917374, -0.04069545865058899],
        "weights_sha256": "c451559353462194162f2e3a6a4add13a7ac0af6d0d394af98c54995989f14ce",
        "forward_flops_per_sample": 3056640,
        "learner_rnn_bound_ms": [16.410621310089553, 65.64248524035821]},
    "grid_gru256": {
        "leaves": GRID_LEAVES,
        "first_weights": [-0.09437709301710129, 0.04495903104543686, 0.03756875917315483, -0.02755095809698105],
        "weights_sha256": "81dbb445914fb2ba607d03f7a9f8b5361659fc223580d5b34af9de06c35001d7",
        "forward_flops_per_sample": 976384,
        "learner_rnn_bound_ms": [1.5512811367164179, 1.5512811367164179]},
}
RECORDED = {  # a record of the tiny run: (dtype, shape) of each part; the observations under their key
    "allegro_lstm512.ppo16k": {
        "obs": {"obs": (torch.float32, (9, 64, 88))}, "actions": (torch.float32, (8, 64, 16)),
        "rewards": (torch.float32, (8, 64)), "dones": (torch.float32, (8, 64)), "time_outs": (torch.float32, (8, 64))},
    "grid_gru256.ppo16k": {
        "obs": {"obs": (torch.uint8, (9, 16, 24, 24, 3))}, "actions": (torch.int32, (8, 16, 1)),
        "rewards": (torch.float32, (8, 16)), "dones": (torch.float32, (8, 16)), "time_outs": (torch.float32, (8, 16))},
}


def pins(name: str) -> dict:
    """What the yardstick makes of a configuration of BENCHMARK.json: its leaves' names and shapes, the weights drawn
    from SEED (the first values of the first leaf, and a SHA-256 of every leaf's bytes in order), the flops of one
    forward of a sample and the least time of one train call's recurrent work at one epoch and at the configuration's
    epochs, at its cell's envs x rollout."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / next(c for c in bench["configs"] if c["name"] == name)["file"]).read_text())
    cell = next(w for w in bench["workloads"] if w["config"] == name)
    traffic = json.loads((ROOT / "port_bench" / "workloads" / f"{cell['name']}.json").read_text())["traffic"]
    config["samples_per_iteration"] = int(traffic["num_envs"]) * int(config["flags"]["rollout"])
    leaves = reference.of(config["model"]).make_leaves(config["model"], SEED, torch.device("cpu"))
    digest = hashlib.sha256()
    for v in leaves.values():
        digest.update(v.detach().contiguous().numpy().tobytes())
    return {
        "leaves": [(k, list(v.shape)) for k, v in leaves.items()],
        "first_weights": next(iter(leaves.values())).flatten()[:4].tolist(), "weights_sha256": digest.hexdigest(),
        "forward_flops_per_sample": flops.forward_flops_per_sample(config["model"]),
        "learner_rnn_bound_ms": [roofline.learner_rnn_bound_ms(config, 1),
                                 roofline.learner_rnn_bound_ms(config, config["flags"]["num_epochs"])],
    }


@pytest.mark.parametrize("name", sorted(PINNED))
def test_leaves_weights_and_counts(name):
    assert pins(name) == PINNED[name]


@pytest.mark.parametrize("workload", sorted(RECORDED))
def test_recorded_keys_and_dtypes(workload, monkeypatch):
    seen = []
    follow = ref_learner.follow

    def recording(config, module, leaves, records, *a, **k):
        seen.append(records)
        return follow(config, module, leaves, records, *a, **k)

    def desc(x):
        return {k: desc(v) for k, v in x.items()} if isinstance(x, dict) else (x.dtype, tuple(x.shape))

    monkeypatch.setattr(ref_learner, "follow", recording)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_cell(workload, 2147483901, 0.2, False, device="cpu", overrides=tiny(workload))
    finally:
        torch.set_num_threads(saved)
    assert r["correct"], r["compared"]
    assert len(seen[0]) == harness.FOLLOWED
    assert all(desc(record) == RECORDED[workload] for record in seen[0])


def made(cfg, obs_space):
    raise AssertionError("not called here")


def test_encoder_factory_registered_for_the_run_and_restored():
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    earlier = factory.encoder_factory

    def before(cfg, obs_space):
        raise AssertionError("not called here")

    factory.register_encoder_factory(before)
    try:
        with harness.encoder_factory("port_bench.tests.test_pb_pinned:made"):
            assert factory.encoder_factory is made
        assert factory.encoder_factory is before
        with harness.encoder_factory(None):  # a configuration that names none keeps the factory found
            assert factory.encoder_factory is before
        with pytest.raises(RuntimeError):
            with harness.encoder_factory("port_bench.tests.test_pb_pinned:made"):
                raise RuntimeError("the run failed")
        assert factory.encoder_factory is before
    finally:
        factory.encoder_factory = earlier
