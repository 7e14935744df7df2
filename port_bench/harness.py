"""One run of one cell: the port's own training loop (`Runner.run` of the runner that `make_rl_runner` builds), a
measured window inside it, and the comparison with the plain reference after it.

A cell is `workloads/<cell>.json` (its configuration's name, its traffic: the env module of `envs/` and its
parameters, the number of envs, sync or async), its configuration
`configs/<config>.json` (the port's flags, the model's widths, the precision and its peak, the limits of the
comparison), and the metrics that BENCHMARK.json names for it, each read by `metrics/<metric>.py`. A configuration
may name its own plain reference (`model.reference`: `reference/<module>.py`, `reference/model.py` by default), declare
its observation keys (`observations`: each key's shape and store, uint8, int32 or float32; by default the one key
`model.obs_key` stored as `obs_store`), and name the encoder factory that its integration registers with the port
(`encoder_factory`: "<module>:<function>", registered for the run and the factory found before restored after it).

The run, in order:
1. Set-up: the runner is built and initialised, and the benchmark writes the weights it made from the seed on the
   device (the reference module's `make_leaves`) into the program's parameters, so that both sides start from them.
2. Warm-up: the first `WARMUP` iterations of `Runner.run`. The first `FOLLOWED` of them are recorded for the reference: the
   rollout's observations (every declared key), actions, rewards, dones and time-outs, and the program's outputs
   (values, log-probs, action parameters, the recurrent states of a sample of envs drawn from the seed), the loss each
   train call reports, Adam's first moment after the first optimizer step and the parameters after the last followed
   call.
3. The window: from a synchronized iteration boundary after the warm-up to the first iteration boundary after
   `seconds`, synchronized again. With `trace` the harness's spans around the rollout and train calls are
   synchronized, and after the window `PROFILED` more iterations run under torch.profiler (device activities only).
   float32 products run in IEEE float32 throughout (TF32 off), as the configurations state.
4. The runner stops (its final save falls after the window); the peak of device memory is read, the program's state
   freed, and the reference follows the recorded iterations.

The context that the metric readers get: `window_env_steps`, `window_s`, `peak_bytes`, `setup_s`, `config`,
`workload`, `steps_per_iteration`; with `trace`, `iterations` (per window iteration: `iteration_ms`, `rollout_ms`,
`learner_ms`, `epochs`) and `profile` (`iterations`, `wall_s`, `busy_s`, `rnn_s`, `epochs` of each).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from port_bench import reference
from sample_factory_tpu_torch.runner.runner import AlgoObserver

ROOT = Path(__file__).resolve().parent.parent
FOLLOWED = 3  # train calls the reference follows
WARMUP = 4  # iterations before the window: the followed ones and one more
PROFILED = 3  # iterations under the profiler after a traced window
SAMPLED_ENVS = 512  # envs whose recurrent states are compared
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sample_factory_tpu", "sf_examples_tpu")


# ------------------------------------------------------------------ finding a cell's parts by name


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_plan(workload: str, root: Path = ROOT) -> Dict:
    """Everything a run of `workload` needs, found by name under `root`: the benchmark's entry for it, its workload
    and configuration files, its env module, and the metrics BENCHMARK.json gives it (end-to-end and per-layer) with
    their readers."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    base = root / "port_bench"
    wl = json.loads((base / "workloads" / f"{workload}.json").read_text())
    config = json.loads((base / "configs" / f"{entry['config']}.json").read_text())
    if wl["config"] != entry["config"] or config["name"] != entry["config"]:
        raise ValueError(f"{workload}: its files name another configuration than BENCHMARK.json")

    return {
        "entry": entry, "workload": wl, "config": config,
        "env_path": base / "envs" / f"{wl['traffic']['env']}.py",
        "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"],
        "metrics_dir": base / "metrics",
    }


def read_metrics(plan: Dict, ctx: Dict, trace: bool) -> Dict[str, Dict]:
    """Each metric of the run's kind read by its own reader; a reader that finds nothing to read in this cell returns
    None, and the metric is left out of the line."""
    out = {}
    for metric in plan["per_layer" if trace else "end_to_end"]:
        reader = load_module(plan["metrics_dir"] / f"{metric['name']}.py", f"port_bench_metric_{metric['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


# ------------------------------------------------------------------ the program's configuration


def port_argv(plan: Dict, seed: int, device: str, train_dir: str) -> List[str]:
    wl, config = plan["workload"], plan["config"]
    traffic = wl["traffic"]
    argv = [f"--env=port_bench_{traffic['env']}", f"--experiment={wl['name']}", f"--train_dir={train_dir}",
            "--restart_behavior=overwrite", f"--seed={seed}", f"--device={device}", f"--num_envs={traffic['num_envs']}",
            "--num_workers=1", "--serial_mode=True", f"--async_rl={traffic['async_rl']}"]
    for key, value in config["flags"].items():
        if isinstance(value, list):
            argv += [f"--{key}"] + [str(v) for v in value]
        else:
            argv.append(f"--{key}={value}")
    return argv


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


# ------------------------------------------------------------------ the run


class _Window(AlgoObserver):
    """The benchmark's observer of the training loop: the warm-up count, the window's ends, the traced iterations and
    the profile after the window."""

    def __init__(self, torch, seconds: float, trace: bool, on_card: bool):
        self.torch, self.seconds, self.trace, self.on_card = torch, seconds, trace, on_card
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)
        self.count = 0
        self.phase = "warmup"
        self.t0 = self.t1 = self.wall0 = None
        self.window_iterations = 0
        self.iterations: List[Dict] = []
        self.spans: List = []  # host spans of the profiled iterations: (name, start us, end us) from the profiler's start
        self.prof = self.prof_t0 = None
        self.prof_epochs: List = []
        self.last_mark = None
        self.current = {}
        self.on_followed: Optional[Callable] = None

    def span(self, name: str, start: float, end: float) -> None:
        if self.phase == "window" and self.trace:
            self.current[f"{name}_ms"] = (end - start) * 1e3
        elif self.phase == "profile":
            self.spans.append((name, (start - self.prof_t0) * 1e6, (end - self.prof_t0) * 1e6))

    @property
    def synced_spans(self) -> bool:
        return self.phase == "window" and self.trace

    def on_training_iteration(self, runner, stats):
        self.count += 1
        if self.phase == "warmup":
            if self.count == FOLLOWED and self.on_followed is not None:
                self.on_followed(runner, stats)
            if self.count >= WARMUP:
                self.sync()
                self.t0, self.wall0 = time.perf_counter(), time.time()
                self.last_mark = self.t0
                self.phase = "window"
            return
        if self.phase == "window":
            self.window_iterations += 1
            now = time.perf_counter()
            if self.trace:
                self.sync()
                now = time.perf_counter()
                self.current.update(iteration_ms=(now - self.last_mark) * 1e3, epochs=float(stats["epochs_executed"]))
                self.iterations.append(self.current)
                self.current = {}
                self.last_mark = now
            if now - self.t0 >= self.seconds:
                self.sync()
                self.t1 = time.perf_counter()
                if self.trace and self.on_card:  # the profile reads the device's activities
                    self.phase = "profile"
                    self.prof = self.torch.profiler.profile(activities=[self.torch.profiler.ProfilerActivity.CUDA])
                    self.prof.start()
                    self.prof_t0 = time.perf_counter()
                    self.prof_count = 0
                else:
                    self.phase = "done"
                    runner.stop()
            return
        if self.phase == "profile":
            self.prof_count += 1
            self.prof_epochs.append(stats["epochs_executed"])
            if self.prof_count >= PROFILED:
                self.sync()
                self.prof_wall = time.perf_counter() - self.prof_t0
                self.prof.stop()
                self.phase = "done"
                runner.stop()


def _faulty(fault: Optional[str], rollout_fn, train_fn, model):
    """Faults planted underneath the timed path, for the check's own tests and readings: a train call that leaves
    the parameters as they were ("frozen"), one that trains on the first half of the envs only, its mean taken over
    them ("half_batch"), and a rollout whose first value is altered where it is produced ("altered")."""
    if fault is None:
        return rollout_fn, train_fn
    import torch

    if fault == "frozen":
        def train(ts, traj, gen=None, *a):
            saved = [p.detach().clone() for p in model.parameters()]
            stats = train_fn(ts, traj, gen, *a)
            with torch.no_grad():
                torch._foreach_copy_(list(model.parameters()), saved)
            return stats
        return rollout_fn, train

    if fault == "half_batch":
        def half(x, n):
            if isinstance(x, dict):
                return {k: half(v, n) for k, v in x.items()}
            return x[:, :n]

        def train(ts, traj, gen=None, *a):
            return train_fn(ts, half(traj, traj["rewards"].shape[1] // 2), gen, *a)
        return rollout_fn, train

    if fault == "altered":
        def rollout(*a):
            ss, traj, ep = rollout_fn(*a)
            traj["values"][0, 0] += 1.0
            return ss, traj, ep
        return rollout, train_fn
    raise ValueError(f"unknown fault {fault!r}")


@contextlib.contextmanager
def encoder_factory(name: Optional[str]):
    """The port's encoder factory "<module>:<function>" registered for the block (none: the factory found is kept),
    and the factory found before restored after it."""
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    found = factory.encoder_factory
    try:
        if name:
            module, function = name.split(":")
            factory.register_encoder_factory(getattr(importlib.import_module(module), function))
        yield
    finally:
        factory.encoder_factory = found


def _host_obs(key: str, x, spec: Dict):
    """A rollout's observations of one key for the reference, on the host, of the shape declared: uint8 where the
    configuration says they are whole numbers in [0, 255], int32 where they are whole numbers (token ids; both
    checked), else float32."""
    import torch

    if tuple(x.shape[2:]) != spec["shape"]:
        raise ValueError(f"observations {key!r} of shape {tuple(x.shape[2:])}, declared {spec['shape']}")
    store = spec["store"]
    if store in ("uint8", "int32"):
        whole = not x.is_floating_point() or bool((x == x.round()).all())
        low, high = (0, 255) if store == "uint8" else (-2**31, 2**31 - 1)
        if not (whole and bool(((x >= low) & (x <= high)).all())):
            raise ValueError(f"observations {key!r} recorded as {store} are not whole numbers in [{low}, {high}]")
        return x.to(torch.uint8 if store == "uint8" else torch.int32).cpu()
    return x.float().cpu()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", overrides: Optional[Dict] = None,
             fault: Optional[str] = None, control: Optional[str] = None, t_start: Optional[float] = None,
             root: Path = ROOT, readings: Sequence[str] = ()) -> Dict:
    """One run; returns the result line's dict (and, under "_numbers", every compared number). `overrides` (tests
    only) replaces flags of the configuration ("flags"), of the traffic ("traffic", "env_params"), the model's widths
    ("model"). `control` runs the reference at that precision in the program's place.
    `readings` (the readings that set the limits): for each precision named, the numbers of the reference at that
    precision in the program's place too, on the same records, under "_readings", with every number's parts.
    The runner's summaries and checkpoints go to a directory of the run's own under TMPDIR, removed when it ends."""
    train_dir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        with reference.searched(root), encoder_factory(cell_plan(workload, root)["config"].get("encoder_factory")):
            return _run_cell(workload, seed, seconds, trace, device, overrides, fault, control, t_start, root,
                             readings, train_dir)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)


def _run_cell(workload, seed, seconds, trace, device, overrides, fault, control, t_start, root, readings,
              train_dir) -> Dict:
    t_start = time.time() if t_start is None else t_start

    def phase(name):
        print(f"port_bench: {name} at {time.time() - t_start:.2f} s", file=sys.stderr, flush=True)

    import torch

    from port_bench import check
    from port_bench.reference import learner as ref_learner
    from port_bench.reference.model import Precision

    plan = cell_plan(workload, root)
    overrides = overrides or {}
    wl, config = dict(plan["workload"]), json.loads(json.dumps(plan["config"]))
    config["flags"].update(overrides.get("flags", {}))
    config["model"].update(overrides.get("model", {}))
    wl["traffic"] = {**wl["traffic"], **overrides.get("traffic", {})}
    wl["traffic"]["env_params"] = {**wl["traffic"]["env_params"], **overrides.get("env_params", {})}
    plan = {**plan, "workload": wl, "config": config}
    traffic, flags = wl["traffic"], config["flags"]
    config["samples_per_iteration"] = int(traffic["num_envs"]) * int(flags["rollout"])

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
    from sample_factory_tpu_torch.envs.env_utils import register_env
    from sample_factory_tpu_torch.train import make_rl_runner

    env_module = load_module(plan["env_path"], f"port_bench_env_{traffic['env']}")
    register_env(f"port_bench_{traffic['env']}",
                 lambda name, cfg=None, env_config=None, render_mode=None: env_module.make_env(traffic["env_params"]))
    argv = port_argv(plan, seed, "gpu" if on_card else "cpu", train_dir)
    parser, _ = parse_sf_args(argv)
    cfg = parse_full_cfg(parser, argv)
    phase("imports done")
    cfg, runner = make_rl_runner(cfg)
    window = _Window(torch, seconds, trace, on_card)
    sync = window.sync
    runner.register_observer(window)
    runner.init()
    phase("runner initialised")

    # the weights, made on the device from the seed, written into the program's parameters
    model_spec = config["model"]
    ref_model = reference.of(model_spec)
    leaves0 = ref_model.make_leaves(model_spec, seed, dev)
    params = dict(runner.train_state.model.named_parameters())
    if set(params) != set(leaves0):
        raise ValueError(f"the program's parameters {sorted(set(params) ^ set(leaves0))} differ from the configuration's")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(leaves0[name].shape):
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)}, the configuration's {tuple(leaves0[name].shape)}")
            p.copy_(leaves0[name])
        if runner.behavior_model is not None:
            torch._foreach_copy_(list(runner.behavior_model.parameters()), list(runner.train_state.model.parameters()))
    leaves0 = {k: v.cpu() for k, v in leaves0.items()}

    # the records of the followed iterations
    N = int(traffic["num_envs"])
    sample = torch.randperm(N, generator=torch.Generator().manual_seed(seed))[: min(SAMPLED_ENVS, N)]
    obs_specs = reference.observations(config)
    records: List[Dict] = []
    prog = {"rollouts": [], "losses": [], "lrs": [], "step_lrs": [[] for _ in range(FOLLOWED)], "first_moment": None,
            "leaves": None}
    optimizer = runner.train_state.optimizer
    names = list(params)

    def first_step(opt, args, kwargs):
        if calls["train"] < FOLLOWED:
            prog["step_lrs"][calls["train"]].append(float(opt.param_groups[0]["lr"]))
        if prog["first_moment"] is None:
            prog["first_moment"] = {n: opt.state[params[n]]["exp_avg"].detach().cpu().clone() for n in names}

    calls = {"rollout": 0, "train": 0}
    hook = optimizer.register_step_post_hook(first_step)
    rollout_fn, train_fn = _faulty(fault, runner._rollout_fn, runner._train_fn, runner.train_state.model)

    def rollout(*a):
        timed = window.synced_spans
        if timed:
            sync()
        start = time.perf_counter()
        ss, traj, ep = rollout_fn(*a)
        if timed:
            sync()
        window.span("rollout", start, time.perf_counter())
        calls["rollout"] += 1
        if calls["rollout"] <= FOLLOWED:
            records.append({"obs": {k: _host_obs(k, traj["obs"][k], spec) for k, spec in obs_specs.items()},
                            **{k: traj[k].cpu() for k in ("actions", "rewards", "dones", "time_outs")}})
            prog["rollouts"].append({"values": traj["values"].cpu(), "log_probs": traj["log_prob_actions"].cpu(),
                                     "params": traj["action_logits"].cpu(),
                                     "states": traj["rnn_states"][:, sample.to(traj["rnn_states"].device)].cpu()})
        return ss, traj, ep

    def train(*a):
        timed = window.synced_spans
        if timed:
            sync()
        start = time.perf_counter()
        stats = train_fn(*a)
        if timed:
            sync()
        window.span("learner", start, time.perf_counter())
        calls["train"] += 1
        if calls["train"] <= FOLLOWED:
            prog["losses"].append(float(stats["loss"]))
            prog["lrs"].append(float(stats["lr"]))
        return stats

    def followed(run, stats):
        hook.remove()
        prog["leaves"] = {n: p.detach().cpu().clone() for n, p in params.items()}

    window.on_followed = followed
    phase("weights written")
    runner._rollout_fn, runner._train_fn = rollout, train
    runner.run()

    phase("runner stopped")
    if window.t1 is None:
        raise RuntimeError("the run ended before its window closed")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or of the JAX package were loaded: {found}")
    steps_per_iteration = runner._transitions_per_iteration()
    ctx = {
        "window_env_steps": window.window_iterations * steps_per_iteration,
        "window_s": window.t1 - window.t0, "window_iterations": window.window_iterations,
        "peak_bytes": peak, "setup_s": window.wall0 - t_start,
        "config": config, "workload": wl, "steps_per_iteration": steps_per_iteration,
    }
    breakdown = None
    if trace:
        ctx["iterations"] = window.iterations
        if window.prof is not None:
            from port_bench import trace as tr

            acts = tr.device_activities(window.prof)
            summary = tr.summarize(acts, window.prof_wall * 1e6, window.spans)
            ctx["profile"] = {"iterations": window.prof_count, "wall_s": window.prof_wall, "busy_s": summary["busy_us"] / 1e6,
                              "rnn_s": summary["rnn_us"] / 1e6, "epochs": [float(e) for e in window.prof_epochs]}
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    metrics = read_metrics(plan, ctx, trace)

    # the program's state is freed before the reference runs
    runner._rollout_fn = runner._train_fn = None
    del runner, params, optimizer, rollout_fn, train_fn
    window.prof = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    phase("program freed")
    limits, readings_out = config["limits"], None
    leaves_dev = {k: v.to(dev) for k, v in leaves0.items()}
    f32 = Precision("float32")
    if control is not None:
        prog = ref_learner.follow(config, ref_model, leaves_dev, records, Precision(control), seed, dev, sample)
    ref = ref_learner.follow(config, ref_model, leaves_dev, records, f32, seed, dev, sample, judged=prog)
    details = {}
    numbers = check.numbers(prog, ref, leaves0, details)
    correct = check.verdict(numbers, limits)
    if readings:
        readings_out = {"program": {"numbers": numbers, "details": details}}
        for name in readings:
            side = ref_learner.follow(config, ref_model, leaves_dev, records, Precision(name), seed, dev, sample)
            judge = ref_learner.follow(config, ref_model, leaves_dev, records, f32, seed, dev, sample, judged=side)
            parts = {}
            readings_out[name] = {"numbers": check.numbers(side, judge, leaves0, parts), "details": parts,
                                  "lrs": side["lrs"], "epoch_kls": side["epoch_kls"]}
            # the program judged by this side in the reference's place
            side = ref_learner.follow(config, ref_model, leaves_dev, records, Precision(name), seed, dev, sample,
                                      judged=prog)
            parts = {}
            readings_out[name]["program"] = {"numbers": check.numbers(prog, side, leaves0, parts), "details": parts}
        readings_out["reference"] = {"losses": ref["losses"], "lrs": ref["lrs"], "epoch_kls": ref["epoch_kls"],
                                     "program_lrs": prog["lrs"], "program_step_lrs": prog.get("step_lrs")}
    phase("compared")
    result = {
        "correct": bool(correct), "attempted": window.window_iterations, "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and "profile" in ctx:
        result["device"]["busy_s"] = ctx["profile"]["busy_s"]
        result["device"]["window_s"] = ctx["profile"]["wall_s"]
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}
    result["_numbers"] = numbers
    if readings_out is not None:
        result["_readings"] = readings_out
    return result
