"""The frozen yardstick against counts worked by hand: the recurrent kernels' least time, the model flops from the
configurations' widths, the device trace's busy union and the RNN kernels' name patterns, and the readers' arithmetic."""

import json
from pathlib import Path

import pytest

from port_bench import flops, roofline, trace
from port_bench.harness import load_module

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())


def test_lstm_bound_at_allegro_minibatch():
    # 2*T*B*G*H*H = 2*16*2048*4*512*512 = 68.72 GFLOP at 67 TFLOP/s: 1.0257 ms, bound by the operations
    ms, by, nbytes, ops = roofline.bound("lstm", 16, 2048, 512, "float32")
    assert ops == 2 * 16 * 2048 * 4 * 512 * 512 and by == "operations"
    assert ms == pytest.approx(1.02566, abs=1e-5)
    ms, by, _, ops = roofline.bwd_bound("lstm", 16, 2048, 512, "float32")
    assert by == "operations" and ms == pytest.approx(1.02566, abs=1e-5)


def test_gru_bound_at_grid_minibatch():
    # bytes: x_proj 32*512*768*2 + h0 512*256*4 + resets 32*512*4 + wh 256*768*2 + outs 32*512*256*4 + h 512*256*4 + bh 768*2
    ms, by, nbytes, _ = roofline.bound("gru", 32, 512, 256, "bfloat16")
    assert nbytes == 32 * 512 * 768 * 2 + 512 * 256 * 4 + 32 * 512 * 4 + 256 * 768 * 2 + 32 * 512 * 256 * 4 + 512 * 256 * 4 + 768 * 2
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_learner_bound_counts_epochs_and_minibatches():
    c = config("allegro_lstm512")
    c["samples_per_iteration"] = 16384 * 16
    assert roofline.learner_rnn_bound_ms(c, 4) == pytest.approx(4 * 8 * 2 * 1.02566, rel=1e-4)


def test_forward_flops_by_hand():
    # MLP 88-512-256-128, LSTM 128->512, critic 512->1, means 512->16
    assert flops.forward_flops_per_sample(config("allegro_lstm512")["model"]) == (
        2 * (88 * 512 + 512 * 256 + 256 * 128) + 2 * 128 * 2048 + 2 * 512 * 2048 + 2 * 512 + 2 * 512 * 16)
    # conv 8x8/4 -> 5x5x16, conv 4x4/2 -> 1x1x32, Dense 32->256, GRU 256->256, critic, 6 logits
    assert flops.forward_flops_per_sample(config("grid_gru256")["model"]) == (
        2 * 5 * 5 * 16 * 8 * 8 * 3 + 2 * 32 * 4 * 4 * 16 + 2 * 32 * 256 + 2 * 2 * 256 * 768 + 2 * 256 + 2 * 256 * 6)
    assert flops.model_flops_per_env_step(config("allegro_lstm512")["model"], 16, 4) == pytest.approx(3056640 * 13.0625)


def test_busy_is_the_union_of_intervals():
    acts = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0), ("d", 21.0, 22.0)]
    assert trace.busy_intervals(acts) == [(0.0, 12.0), (20.0, 25.0)]
    s = trace.summarize(acts, 30.0, [("rollout", 11.0, 19.0), ("learner", 24.0, 30.0)], patterns=[])
    assert s["busy_us"] == 17.0 and s["rnn_us"] == 0.0
    assert s["idle_gaps"][0] == ["rollout", 8e-6] and s["idle_gaps"][1] == ["learner", 5e-6]


def test_rnn_kernel_patterns():
    pats = trace.rnn_patterns()
    hit = ["void (anonymous namespace)::grid_kernel<LstmCells, 8, 8>(float const*, int)",
           "void (anonymous namespace)::seq_bwd_grid_kernel<LstmBwdCells>((anonymous namespace)::BwdArgs<float>)",
           "void (anonymous namespace)::seq_cluster_kernel<__nv_bfloat16, 3>(__nv_bfloat16 const*)",
           "void (anonymous namespace)::seq_bwd_cluster_kernel<__nv_bfloat16, 3>((anonymous namespace)::BwdArgs<__nv_bfloat16>)",
           "void (anonymous namespace)::lstm_resident_in_kernel<float, 4>((anonymous namespace)::InArgs<float>, int)"]
    miss = ["void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)",
            "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>(Params)",
            "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_grid_kernel"]
    assert all(any(p.search(n) for p in pats) for n in hit)
    assert not any(any(p.search(n) for p in pats) for n in miss)


def reader(name):
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py", f"t_{name}")


def test_readers_on_a_context_worked_by_hand():
    c = config("allegro_lstm512")
    c["samples_per_iteration"] = 16384 * 16
    prof = {"iterations": 2, "wall_s": 1.0, "busy_s": 0.8, "rnn_s": 0.5, "epochs": [4.0, 4.0]}
    ctx = {"config": c, "steps_per_iteration": 262144, "profile": prof, "window_env_steps": 10 * 262144,
           "window_s": 5.0, "peak_bytes": 2**31, "setup_s": 12.5,
           "iterations": [{"iteration_ms": 500.0, "rollout_ms": 40.0, "learner_ms": 450.0, "epochs": 4.0}]}
    assert reader("device_idle").read(ctx) == pytest.approx(20.0)
    assert reader("rnn_ms").read(ctx) == pytest.approx(250.0)
    assert reader("rnn_roofline").read(ctx) == pytest.approx(100 * 2 * 32 * 2 * 1.02566 / 500.0, rel=1e-4)
    assert reader("mfu").read(ctx) == pytest.approx(100 * 2 * 262144 * 3056640 * 13.0625 / 67e12)
    assert reader("runner_self_ms").read(ctx) == pytest.approx(10.0)
    assert reader("env_steps_per_s").read(ctx) == pytest.approx(2 * 262144)
    assert reader("peak_mem_gib").read(ctx) == pytest.approx(2.0)
    assert reader("epochs_per_iter").read(ctx) == 4.0


def test_readers_without_a_trace_return_nothing():
    ctx = {"profile": {"iterations": 2, "wall_s": 1.0, "busy_s": 0.0, "rnn_s": 0.0, "epochs": [1.0, 1.0]}}
    assert reader("rnn_ms").read(ctx) is None and reader("rnn_roofline").read(ctx) is None
    assert reader("learner_ms").read({}) is None and reader("device_idle").read({}) is None
