"""A configuration of two observation keys with a plain reference of its own (`reference/two_key.py`), its own env
and one cell, added as new files alone to a copy of the benchmark (the files in `tests/two_key/`): the harness takes
them with no file of port_bench/ edited, records both keys in their stores (uint8 frames, int32 ids), registers the
encoder factory that the configuration names, counts flops and recurrent work by the module's own counts, and the
run agrees with the reference, while each fault planted underneath the timed path does not. The configuration
normalizes only the key "obs" (`normalize_input_keys`), so a reference that normalized the ids too would fail it."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import flops, reference, roofline
from port_bench.harness import run_cell
from port_bench.reference import learner as ref_learner

ROOT = Path(__file__).resolve().parents[2]
FILES = Path(__file__).resolve().parent / "two_key"
PLACES = {"two_key.json": "configs", "two_key.py": "reference", "two_key_env.py": "envs",
          "two_key.tiny.json": "workloads"}
SEED = 2147483917
BUILT = []  # the observation keys of each encoder that `make_encoder` built


def make_encoder(cfg, obs_space):
    """The port's default MultiInputEncoder, registered by the configuration's `encoder_factory`."""
    from sample_factory_tpu_torch.models.encoder import default_make_encoder
    from sample_factory_tpu_torch.models.model_utils import default_compute_dtype

    BUILT.append(sorted(obs_space.keys()))
    return default_make_encoder(cfg, obs_space, default_compute_dtype(cfg))


def snapshot(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def plant(tmp_path: Path, change=None):
    """A copy of the benchmark with the two-key files added (the configuration changed by `change` first); returns the
    bytes of every file that the copy had before."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = snapshot(tmp_path)
    for name, place in PLACES.items():
        assert not (tmp_path / "port_bench" / place / name).exists()
        shutil.copy(FILES / name, tmp_path / "port_bench" / place / name)
    config = json.loads((FILES / "two_key.json").read_text())
    if change:
        change(config)
    (tmp_path / "port_bench" / "configs" / "two_key.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "two_key", "source": config["source"], "file": "port_bench/configs/two_key.json",
                             "reduced": [], "why": "a test's configuration"})
    bench["workloads"].append({"name": "two_key.tiny", "config": "two_key", "traffic": "tiny", "chips": 1,
                               "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run(root, records=None, **kw):
    """run_cell of the two-key cell on the CPU; `records` gets the first record that the reference follows."""
    follow = ref_learner.follow

    def recording(config, module, leaves, recs, *a, **k):
        if records is not None and not records:
            records.append(recs[0])
        return follow(config, module, leaves, recs, *a, **k)

    ref_learner.follow = recording
    try:
        return run_cell("two_key.tiny", SEED, 0.2, False, device="cpu", root=root, **kw)
    finally:
        ref_learner.follow = follow


def no_instruction_norm(config):
    assert config["flags"]["normalize_input_keys"] == ["obs"]


def every_key(config):
    del config["flags"]["normalize_input_keys"]  # the port's default: every key normalized


def no_core(config):
    config["flags"]["use_rnn"] = False
    config["model"]["core"] = {"type": "none"}
    del config["limits"]["state_gap"]


@pytest.mark.parametrize("change", [no_instruction_norm, every_key, no_core])
def test_two_keys_by_files_alone(tmp_path, change):
    from sample_factory_tpu_torch.algo.context import global_model_factory

    before = plant(tmp_path, change)
    found = global_model_factory().encoder_factory
    BUILT.clear()
    records = []
    r = run(tmp_path, records)
    assert r["correct"], r["compared"]
    assert BUILT and all(keys == ["obs", "tokens"] for keys in BUILT)
    assert global_model_factory().encoder_factory is found
    obs = records[0]["obs"]
    assert (obs["obs"].dtype, tuple(obs["obs"].shape)) == (torch.uint8, (9, 16, 24, 24, 3))
    assert (obs["tokens"].dtype, tuple(obs["tokens"].shape)) == (torch.int32, (9, 16, 8))
    assert int(obs["tokens"].max()) > 1  # ids, not a normalized or a flag-like key
    after = snapshot(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    assert ("state_gap" in r["compared"]) == (change is not no_core)


def test_counts_of_the_configurations_own_module(tmp_path):
    plant(tmp_path)
    config = json.loads((tmp_path / "port_bench" / "configs" / "two_key.json").read_text())
    config["samples_per_iteration"] = 16 * 8
    with pytest.raises(ModuleNotFoundError):  # a module of the copy alone is found only while a run searches it
        flops.forward_flops_per_sample(config["model"])
    with reference.searched(tmp_path):
        # conv 8x8/4 -> 5x5x16, conv 4x4/2 -> 1x1x32, Dense 32->16; tokens 8->8; LSTM 24->16; critic and 4 logits
        assert flops.forward_flops_per_sample(config["model"]) == (
            2 * 5 * 5 * 16 * 8 * 8 * 3 + 2 * 32 * 4 * 4 * 16 + 2 * 32 * 16 + 2 * 8 * 8
            + 2 * 24 * 64 + 2 * 16 * 64 + 2 * 16 * 5)
        one = roofline.bound("lstm", 8, 8, 16, "float32")[0] + roofline.bwd_bound("lstm", 8, 8, 16, "float32")[0]
        assert roofline.learner_rnn_bound_ms(config, 2) == pytest.approx(2 * 2 * one, rel=1e-12)
    with pytest.raises(ModuleNotFoundError):
        roofline.learner_rnn_bound_ms(config, 2)


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered"])
def test_a_fault_underneath_the_timed_path_is_not_correct(tmp_path, fault):
    plant(tmp_path)
    r = run(tmp_path, fault=fault)
    assert not r["correct"], (fault, r["compared"])
