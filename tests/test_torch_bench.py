"""bench_gpu.py, the port's benchmark, held to bench.py on the CPU.

- Argv parity: every scenario passes bench.py's configuration, letter for letter, except the
  flags the port names as its own (`--device`, `--train_dir`: the port writes under a temporary
  directory; `--jax_distributed`) and the `_tpu` -> `_gpu` experiment name.
- Flop accounting: the analytic count equals bench.py's exactly on the port's copy of each model
  (parameters carried over by the bridge). FlopCounterMode counts the same matmuls and
  convolutions as the analytic count and nothing else, so their ratio is held to 1 within
  COUNTED_OVER_ANALYTIC; XLA's cost analysis also counts elementwise work, so the counted flops
  lie below it, within COUNTED_OVER_XLA.
- MFU fields, the measuring windows, smoke runs of two scenarios on the CPU, the error row and
  the exit codes.
"""

import inspect
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
import bench_gpu
import sample_factory_tpu.cfg.arguments as jax_arguments
import sample_factory_tpu_torch.cfg.arguments as torch_arguments
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs import spaces as jspaces
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs import spaces as tspaces
from sample_factory_tpu_torch.models.actor_critic import actor_critic_rnn_state_size, create_actor_critic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = bench_gpu.Bench(torch.device("cpu"), bench_gpu.FULL, bench_gpu.Card("cpu", None))
COUNTED_OVER_ANALYTIC = (0.999, 1.001)
COUNTED_OVER_XLA = (1 / 1.5, 1.0)
PORT_OWN_FLAGS = ("--device=", "--train_dir=", "--jax_distributed=")


class Captured(Exception):
    pass


def _capture(monkeypatch, module, name, call):
    """The arguments of module.name in `call`, bound to its signature with defaults applied."""
    target = getattr(module, name)
    seen = {}

    def record(*args, **kwargs):
        bound = inspect.signature(target).bind(*args, **kwargs)
        bound.apply_defaults()
        seen.update(bound.arguments)
        raise Captured

    monkeypatch.setattr(module, name, record)
    with pytest.raises(Captured):
        call()
    monkeypatch.undo()
    return seen


def _own(argv):
    return [a.replace("_tpu", "_gpu") for a in argv if not a.startswith(PORT_OWN_FLAGS)]


SYNC_SCENARIOS = ["bench_mlp_synthetic", "bench_ant_physics", "bench_grid_battle", "bench_pixel_inference_only"]


@pytest.mark.parametrize("scenario", SYNC_SCENARIOS)
def test_default_cfg_argv_matches_bench(monkeypatch, scenario):
    want = _capture(monkeypatch, jax_arguments, "default_cfg", getattr(bench, scenario))
    got = _capture(monkeypatch, torch_arguments, "default_cfg", lambda: getattr(bench_gpu, scenario)(CPU))
    assert got["env"] == want["env"]
    assert got["argv"] == want["argv"]


@pytest.mark.parametrize("jax_fn,torch_fn", [("_host_pixel_child", "bench_host_pixel"), ("bench_host_pixel_tpu", "bench_host_pixel_gpu")])
def test_host_pixel_argv_matches_bench(monkeypatch, jax_fn, torch_fn):
    want = _capture(monkeypatch, bench, "_host_pixel_measure", getattr(bench, jax_fn))
    got = _capture(monkeypatch, bench_gpu, "_host_pixel_measure", lambda: getattr(bench_gpu, torch_fn)(CPU))
    assert _own(got["extra_argv"]) == _own(want["extra_argv"])
    assert (got["n_iters"], got["warmup"]) == (want["n_iters"], want["warmup"])
    assert _own(bench_gpu._HOST_PIXEL_BASE_ARGV) == _own(bench._HOST_PIXEL_BASE_ARGV)


def _jax_scaling_child():
    sys.argv = ["bench.py", "--scaling-child", "0", "0", "1", "0"]
    return bench._scaling_child()


@pytest.mark.parametrize("jax_call,torch_call", [
    (lambda: bench._host_pixel_measure(["--experiment=x", "--num_workers=2"]),
     lambda: bench_gpu._host_pixel_measure(CPU, ["--experiment=x", "--num_workers=2"])),
    (bench._producer_child, lambda: bench_gpu.bench_producer(CPU)),
    (_jax_scaling_child, lambda: bench_gpu._scaling_child(0, 0, 1, 0, "unused", bench_gpu.FULL)),
], ids=["host_pixel_measure", "producer", "scaling"])
def test_parse_sf_args_argv_matches_bench(monkeypatch, jax_call, torch_call):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    noop = lambda *args: None  # noqa: E731 - the scaling child pins its process to one core
    monkeypatch.setattr(os, "sched_setaffinity", noop)
    want = _capture(monkeypatch, jax_arguments, "parse_sf_args", jax_call)
    monkeypatch.setattr(os, "sched_setaffinity", noop)
    got = _capture(monkeypatch, torch_arguments, "parse_sf_args", torch_call)
    assert _own(got["argv"]) == _own(want["argv"])


# ------------------------------------------------------------------ flop accounting

MODELS = {
    "mlp": (["--use_rnn=False", "--encoder_mlp_layers", "256", "128", "64", "--normalize_input=True", "--seed=0"],
            "Box", (60,), 0.0, 1.0, "float32"),
    "grid_battle": (["--use_rnn=True", "--rnn_type=gru", "--rnn_size=256", "--encoder_conv_architecture=convnet_impala",
                     "--encoder_conv_mlp_layers", "256", "--compute_dtype=bfloat16", "--seed=0"],
                    "Discrete", (24, 24, 3), 0.0, 1.0, "float32"),
    "host_pixel": (["--use_rnn=False", "--encoder_conv_architecture=convnet_simple", "--encoder_conv_mlp_layers", "128",
                    "--normalize_input=True", "--seed=0"], "Discrete", (42, 42, 4), 0, 255, "uint8"),
}


def _model_pair(name):
    """bench.py's model of a scenario and the port's, with the flax parameters carried over."""
    argv, action, shape, low, high, dtype = MODELS[name]
    jcfg, tcfg = jax_default_cfg(env="b", argv=argv), default_cfg(env="b", argv=argv + ["--device=cpu"])

    def spaces(mod):
        act = mod.Box((8,), -1.0, 1.0) if action == "Box" else mod.Discrete(6)
        return mod.make_dict_spec({"obs": mod.Box(shape, low, high, dtype)}), act

    jmodel = jax_create_actor_critic(jcfg, *spaces(jspaces))
    tmodel = create_actor_critic(tcfg, *spaces(tspaces))
    rnn_width = actor_critic_rnn_state_size(tcfg)
    obs = np.random.default_rng(0).integers(0, 255, (2,) + shape).astype(dtype)
    rnn = np.zeros((2, rnn_width), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), {"obs": jnp.asarray(obs)}, jnp.asarray(rnn))
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    return (jmodel, params, {"obs": jnp.asarray(obs)}, jnp.asarray(rnn)), (tmodel, {"obs": torch.tensor(obs)}, torch.tensor(rnn))


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_pair(request):
    return _model_pair(request.param)


def test_analytic_flops_equal_bench(model_pair):
    (jmodel, params, jobs, jrnn), (tmodel, tobs, trnn) = model_pair
    want = bench._analytic_fwd_flops(jmodel, params, jobs, jrnn)
    assert want is not None and want > 0
    assert bench_gpu._analytic_fwd_flops(tmodel, tobs, trnn) == want


def test_counted_flops_within_the_stated_bounds(model_pair):
    (jmodel, params, jobs, jrnn), (tmodel, tobs, trnn) = model_pair
    counted = bench_gpu._fwd_flops_per_sample(tmodel, tobs, trnn, batch=256)
    analytic = bench_gpu._analytic_fwd_flops(tmodel, tobs, trnn)
    xla = bench._fwd_flops_per_sample(jmodel, params, jobs, jrnn, batch=256)
    assert COUNTED_OVER_ANALYTIC[0] <= counted / analytic <= COUNTED_OVER_ANALYTIC[1], (counted, analytic)
    assert COUNTED_OVER_XLA[0] <= counted / xla <= COUNTED_OVER_XLA[1], (counted, xla)
    counted_fields = bench_gpu._flops_fields(tmodel, tobs, trnn, batch=256)[1]
    assert "flops_xcheck_violation" not in counted_fields and 0.9 <= counted_fields["flops_xcheck_ratio"] <= 1.5


# ------------------------------------------------------------------ MFU and windows

H100_SXM = bench_gpu.Card("NVIDIA H100 80GB HBM3", 700.0)


def test_mfu_fields_match_bench():
    for fwd, fps, rollout, epochs in ((1e6, 5e4, 16, 2), (976384.0, 150000.0, 32, 1), (2098944.0, 1.2e5, 32, 1)):
        want = bench._mfu_fields(fwd, fps, rollout, epochs)
        got = bench_gpu._mfu_fields(fwd, fps, rollout, epochs, H100_SXM)
        assert got["model_flops_per_env_step"] == want["model_flops_per_env_step"]
        assert got["tflops"] == want["tflops"]
        assert got["device"] == H100_SXM.name and got["power_limit_w"] == 700.0
        assert got["mfu_peak_tflops_bf16"] == 989.0 and got["mfu"] == round(fps * got["model_flops_per_env_step"] / 989e12, 5)
        assert "mfu_violation" not in got


def test_mfu_violation_flagged_and_unknown_card_has_no_mfu(capsys):
    fields = bench_gpu._mfu_fields(1e6, fps=1e12, rollout=16, num_epochs=1, card=H100_SXM)
    assert fields["mfu"] >= 1 and fields["mfu_violation"] is True
    assert "impossible MFU" in capsys.readouterr().err
    unknown = bench_gpu._mfu_fields(1e6, fps=1e12, rollout=16, num_epochs=1, card=bench_gpu.Card("NVIDIA A100-SXM4-80GB", 400.0))
    assert not {"mfu", "mfu_peak_tflops_bf16", "mfu_violation"} & set(unknown) and unknown["device"] == "NVIDIA A100-SXM4-80GB"
    assert bench_gpu._device_peak_bf16("NVIDIA H100 PCIe") == 756.5e12 and bench_gpu._device_peak_bf16("NVIDIA H100 NVL") == 835.5e12


@pytest.mark.parametrize("reps,window", [(5, None), (3, None), (2, 10)])
def test_measure_fps_windows(reps, window):
    x = torch.zeros(64)
    calls = []

    def step_once():
        calls.append(1)
        x.add_(1.0)

    fps, fields = bench_gpu._measure_fps_windows(step_once, 7, reps=reps, target_window_s=0.01, sync=lambda: None, window=window)
    W = fields["window_iters"]
    assert len(fields["fps_windows"]) == reps and fields["fps_spread_pct"] >= 0 and 10 <= W <= 1200
    assert len(calls) == (0 if window else 10) + reps * W and (window is None or W == window)
    assert abs(fps - sorted(fields["fps_windows"])[reps // 2]) <= 0.1 and fields["fps_best"] >= fps - 0.1


# ------------------------------------------------------------------ smoke runs on the CPU

CARD_KEYS = {"metric", "value", "unit", "vs_baseline", "model_flops_per_env_step", "tflops", "device", "power_limit_w",
             "mfu", "mfu_peak_tflops_bf16", "fwd_flops_per_sample", "fwd_flops_analytic", "flops_xcheck_ratio", "fps_windows",
             "fps_best", "fps_spread_pct", "window_iters", "iterations_counted", "rnn_kernel_launches", "note", "seconds"}
SMOKE_RUNS = {
    "mlp": (bench_gpu.s_mlp, ("--num_envs=64", "--batch_size=512", "--encoder_mlp_layers", "32", "32"), CARD_KEYS),
    "grid_battle": (bench_gpu.s_grid_battle, ("--num_envs=8", "--batch_size=128", "--rnn_size=32", "--encoder_conv_mlp_layers", "32"),
                    CARD_KEYS | set(bench_gpu.DEVICE_TRACE_KEYS) | {"gru_seq_launches_per_iteration"}),
}


@pytest.mark.parametrize("name", sorted(SMOKE_RUNS))
def test_smoke_run_on_the_cpu(name):
    fn, overrides, card_keys = SMOKE_RUNS[name]
    b = bench_gpu.Bench(torch.device("cpu"), bench_gpu.SMOKE, bench_gpu.Card("cpu", None), overrides)
    suite = []
    assert bench_gpu._try_scenario(suite, name, fn, b)
    row = suite[0]
    assert set(row) == card_keys - {"mfu", "mfu_peak_tflops_bf16"}
    assert math.isfinite(row["value"]) and row["value"] > 0 and row["device"] == "cpu" and row["power_limit_w"] is None
    assert row["window_iters"] == 10 and len(row["fps_windows"]) == 1 and row["iterations_counted"] == 10
    assert row["flops_xcheck_ratio"] == 1.0 and row["fwd_flops_per_sample"] > 0
    assert not any(row["rnn_kernel_launches"].values())  # the plain versions run on the CPU
    assert all(row[k] is None for k in set(bench_gpu.DEVICE_TRACE_KEYS) & set(row))  # not measured without the card
    json.dumps(row)


def test_failed_scenario_gives_an_error_row_and_exit_code_1(monkeypatch, capsys):
    def broken(b):
        raise ValueError("broken scenario")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_gpu, "read_card", lambda device: bench_gpu.Card("cpu", None))
    monkeypatch.setattr(bench_gpu, "SCENARIOS", [("broken_metric", broken)])
    monkeypatch.setattr(bench_gpu, "HEADLINE", ("headline_metric", lambda b: {"value": 1.0, "unit": "env_steps/s", "vs_baseline": 0.5}))
    assert bench_gpu.main(["--smoke"]) == 1
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0].pop("seconds") >= 0
    assert rows[0] == {"metric": "broken_metric", "error": "ValueError: broken scenario", "device": "cpu", "power_limit_w": None}
    assert rows[-1]["metric"] == "headline_metric" and rows[-1]["suite"][0] == {**rows[0], "seconds": rows[-1]["suite"][0]["seconds"]}
    assert rows[-1]["suite"][-1] == {"metric": "headline_metric", "value": 1.0, "unit": "env_steps/s", "vs_baseline": 0.5}


def test_no_card_exits_2_without_a_rate():
    out = subprocess.run([sys.executable, "bench_gpu.py"], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == "" and "CUDA card" in out.stderr
