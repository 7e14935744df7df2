"""Runs of both cells at sizes a CPU test can hold, through the whole harness but its look for a card: the port's CPU
path agrees with the plain reference within the cells' limits; a bfloat16 run of the float32 configuration, the
controls, and each fault planted underneath the timed path come out not correct. On the card (marker `cuda`), the
controls at the same sizes."""

import pytest
import torch

from port_bench.harness import run_cell
from port_bench.tests.tiny import tiny

CELLS = ["allegro_lstm512.ppo16k", "grid_gru256.ppo16k"]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def run(workload, device="cpu", trace=False, **kw):
    return run_cell(workload, 2147483901, 0.2, trace, device=device, overrides=tiny(workload, **kw.pop("flags", {})), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload):
    r = run(workload)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}  # no device: no peak
    assert r["compared"] and all(c["value"] <= c["limit"] for c in r["compared"].values())


def test_traced_run_reads_the_host_spans():
    r = run("grid_gru256.ppo16k", trace=True)
    assert r["correct"]
    # no device here: the profile and the metrics that read it are left out, never reported as 0
    assert set(r["metrics"]) == {"runner_self_ms", "rollout_ms", "learner_ms", "epochs_per_iter"}
    assert r["metrics"]["epochs_per_iter"]["value"] == 1.0 and r["metrics"]["learner_ms"]["value"] > 0
    assert "busy_s" not in r["device"] and "breakdown" not in r


def test_bfloat16_run_of_the_float32_configuration_fails():
    r = run("allegro_lstm512.ppo16k", flags={"compute_dtype": "bfloat16"})
    assert not r["correct"]


def test_float8_control_fails_the_bfloat16_configuration():
    assert not run("grid_gru256.ppo16k", control="float8")["correct"]


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_underneath_the_timed_path_is_not_correct(workload, fault):
    r = run(workload, fault=fault)
    assert not r["correct"], (fault, r["compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [("allegro_lstm512.ppo16k", "tf32"), ("grid_gru256.ppo16k", "float8")])
def test_control_on_the_card(card, workload, control):
    assert run(workload, device=card)["correct"]
    assert not run(workload, device=card, control=control)["correct"]
