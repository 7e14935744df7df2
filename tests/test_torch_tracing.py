"""The port's tracer (`utils/timing.py`): off unless a torch.profiler session records at an iteration's start; on, the
training loop's spans with their parents, each carried by the profiler's trace inside its own interval on the shared
clock; the host syncs counted per iteration; the benchmark's six readers of the records; `--profiler_dir`'s window.
The test marked `cuda` holds a span against the kernel it encloses on the card."""

import json
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sample_factory_tpu_torch.utils import timing
from sample_factory_tpu_torch.utils.timing import Timing, Tracer, tracer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
READERS = ("host_syncs_per_iter", "sync_wait_ms", "prepare_batch_ms", "minibatch_ms", "rollout_step_ms", "env_step_ms")
T, ENVS, BATCH = 4, 8, 16  # rollout, envs: 2 minibatches an epoch


def _argv(train_dir, iterations, *extra):
    return ["--env=synthetic_vector_discrete", "--device=cpu", "--async_rl=False", f"--num_envs={ENVS}",
            f"--rollout={T}", f"--recurrence={T}", f"--batch_size={BATCH}", "--use_rnn=True", "--rnn_size=16",
            "--encoder_mlp_layers", "16", f"--train_for_env_steps={iterations * T * ENVS}", f"--train_dir={train_dir}",
            "--experiment=tracing", "--seed=3", "--learning_rate=0.001", "--experiment_summaries_interval=1000",
            *extra]


def _runner(tmp_path, iterations, *extra):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    _, runner = make_rl_runner(parse_custom_args(_argv(tmp_path, iterations, *extra)))
    runner.init()
    return runner


def _profiled_run(tmp_path, iterations, *extra):
    runner = _runner(tmp_path, iterations, *extra)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert runner.run() == 0
    return runner, prof


def _reader(name):
    from port_bench.harness import load_module

    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py", f"tracing_test_{name}")


def test_off_by_default_nothing_recorded_no_clock_read(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    fresh = Tracer()
    fresh.begin_iteration()  # no profiler records: stays off

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(timing.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(timing.time, "time_ns", no_clock)
    for tr in (fresh, tracer()):
        assert not tr.on
        null = tr.span("a")
        assert tr.span("b") is null  # one shared null context: nothing allocated
        with tr.span("learner"):
            tr.count("host_syncs")
            assert tr.host_read("valid_frac", torch.tensor(0.25)) == 0.25
            assert torch.equal(tr.host_read("perm", torch.arange(3)), torch.arange(3))
    assert fresh.spans == [] and fresh.counters == [] and fresh.iterations == 0


def test_timing_adds_up_by_key():
    t = Timing()
    for _ in range(2):
        with t.add_time("save"):
            time.sleep(0.001)
    with t.add_time("rollout"):
        pass
    assert t.flat_str().startswith("save: 0.00") and ", rollout: " in t.flat_str()


PARENTS = {
    "iteration": None, "rollout": "iteration", "rollout.step": "rollout", "rollout.policy": "rollout.step",
    "rollout.env": "rollout.step", "learner": "iteration", "learner.prepare_batch": "learner",
    "learner.normalize": "learner.prepare_batch", "learner.bootstrap": "learner.prepare_batch",
    "learner.advantages": "learner.prepare_batch", "sync.valid_frac": "learner.prepare_batch",
    "learner.epoch": "learner", "learner.minibatch": "learner.epoch", "learner.forward": "learner.minibatch",
    "learner.backward": "learner.minibatch", "learner.optimizer": "learner.minibatch",
}


def test_profiled_run_records_the_spans_inside_their_profiler_events(tmp_path):
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    class Observer(AlgoObserver):
        def __init__(self):
            self.spans = []

        def span(self, name, start_s, end_s):
            self.spans.append((name, start_s, end_s))

    runner = _runner(tmp_path, 2)
    observer = Observer()
    runner.register_observer(observer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert runner.run() == 0
    tr = tracer()
    assert not tr.on and tr.iterations == 2
    names = [s.name for s in tr.spans]
    assert set(names) == set(PARENTS)  # one epoch at a constant rate: no other sync in an iteration
    for s in tr.spans:
        assert s.parent == PARENTS[s.name], s
        assert s.end_ns >= s.start_ns and s.iteration in (0, 1)
    per_iteration = {name: names.count(name) / 2 for name in PARENTS}
    assert per_iteration["rollout.step"] == per_iteration["rollout.env"] == T
    assert per_iteration["learner.minibatch"] == ENVS * T // BATCH and per_iteration["iteration"] == 1
    # the observers get every span, in perf_counter seconds: the same durations
    assert [o[0] for o in observer.spans] == names
    for (_, a, b), s in zip(observer.spans, tr.spans):
        assert abs((b - a) * 1e9 - (s.end_ns - s.start_ns)) < 1e3

    # each span's record_function event lies inside the span's own interval, on the profiler's clock
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in PARENTS:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in PARENTS:
        spans = sorted((s.start_ns, s.end_ns) for s in tr.spans if s.name == name)
        assert len(events[name]) == len(spans), name
        for (es, ee), (ss, se) in zip(sorted(events[name]), spans):
            assert ss <= es <= ee <= se, (name, ss - es, se - ee)


@pytest.mark.parametrize("schedule,epochs,syncs", [
    ("constant", 1, 1),  # the valid fraction
    ("kl_adaptive_epoch", 3, 1 + 2 * 3),  # and each epoch's loss and KL
    ("kl_adaptive_minibatch", 1, 1 + ENVS * T // BATCH),  # and each minibatch's KL
])
def test_host_syncs_per_iteration(tmp_path, schedule, epochs, syncs):
    runner, _ = _profiled_run(tmp_path, 2, f"--lr_schedule={schedule}", f"--num_epochs={epochs}",
                              "--lr_schedule_kl_threshold=1e9")  # the KL never passes it: no early stop by KL
    tr = tracer()
    assert runner.host_stats()["epochs_executed"] == epochs  # no early stop on the epoch loss either
    assert [c["host_syncs"] for c in tr.counters] == [syncs, syncs]
    syncs_seen = [s for s in tr.spans if s.name.startswith("sync.")]
    assert len(syncs_seen) == 2 * syncs
    assert _reader("host_syncs_per_iter").read({}) == syncs
    assert _reader("sync_wait_ms").read({}) == pytest.approx(sum(s.ms for s in syncs_seen) / 2)
    minibatches = [s.ms for s in tr.spans if s.name == "learner.minibatch"]
    assert len(minibatches) == 2 * epochs * ENVS * T // BATCH
    assert _reader("minibatch_ms").read({}) == pytest.approx(sum(minibatches) / len(minibatches))
    for name in ("prepare_batch_ms", "rollout_step_ms", "env_step_ms"):
        assert _reader(name).read({}) > 0


def test_readers_return_none_on_an_untraced_run(tmp_path):
    _profiled_run(tmp_path / "traced", 1)
    assert tracer().iterations == 1
    runner = _runner(tmp_path / "untraced", 1)
    assert runner.run() == 0  # a run starts with no records: the last traced stretch is gone
    assert tracer().iterations == 0 and tracer().spans == []
    for name in READERS:
        assert _reader(name).read({}) is None, name


def test_profiler_dir_traces_the_iterations_after_the_first_four(tmp_path):
    profile_dir = tmp_path / "profile"
    runner = _runner(tmp_path, 6, f"--profiler_dir={profile_dir}")
    assert runner.run() == 0
    assert tracer().iterations == 2  # iterations 5 and 6: the window closes with the run
    trace = json.loads((profile_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"iteration", "learner.minibatch", "rollout.env", "sync.valid_frac"} <= names


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()  # warm: the library's handles made before the profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.begin_iteration()
        for _ in range(3):
            with tr.span("matmul"):
                a @ a
                torch.cuda.synchronize()
        tr.end()
    kernels = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA and "gemm" in e.name().lower())
    spans = sorted((s.start_ns, s.end_ns) for s in tr.spans)
    assert len(kernels) == len(spans) == 3
    for (ks, ke), (ss, se) in zip(kernels, spans):
        assert ss - 50_000 <= ks and ke <= se + 50_000, (ks - ss, se - ke)
