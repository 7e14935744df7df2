"""A cell and a per-layer metric added as files alone, in a copy of the benchmark, are found by the harness by their
names, with no file of port_bench/ edited: BENCHMARK.json names them, and the files hold the rest."""

import json
import shutil
from pathlib import Path

from port_bench.harness import cell_plan, read_metrics, run_cell
from port_bench.tests.tiny import tiny

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_and_metric_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}

    wl = json.loads((ROOT / "port_bench" / "workloads" / "allegro_lstm512.ppo16k.json").read_text())
    wl.update(name="allegro_lstm512.short_episodes")
    wl["traffic"]["env_params"]["episode_len"] = 50
    (tmp_path / "port_bench" / "workloads" / "allegro_lstm512.short_episodes.json").write_text(json.dumps(wl))
    (tmp_path / "port_bench" / "metrics" / "lstm_window_iterations.py").write_text(
        "def read(ctx):\n"
        "    return ctx['window_iterations'] if ctx['config']['model']['core']['type'] == 'lstm' else None\n")
    bench["workloads"].append({"name": "allegro_lstm512.short_episodes", "config": "allegro_lstm512",
                               "traffic": "short_episodes", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "lstm_window_iterations", "unit": "iterations", "better": "higher",
                                "bound": 0.05, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    plan = cell_plan("allegro_lstm512.short_episodes", root=tmp_path)
    assert plan["workload"]["traffic"]["env_params"]["episode_len"] == 50
    ctx = {"window_iterations": 7, "window_s": 1.0, "window_env_steps": 10, "setup_s": 1.0, "peak_bytes": 0}
    assert read_metrics(plan, {**ctx, "config": plan["config"]}, False)["lstm_window_iterations"]["value"] == 7.0
    grid = cell_plan("grid_gru256.ppo16k", root=tmp_path)  # its reader finds nothing there: left out of the line
    assert "lstm_window_iterations" not in read_metrics(grid, {**ctx, "config": grid["config"]}, False)

    r = run_cell("allegro_lstm512.short_episodes", 5, 0.2, False, device="cpu",
                 overrides=tiny("allegro_lstm512.ppo16k"), root=tmp_path)
    assert r["correct"] and r["metrics"]["lstm_window_iterations"]["value"] >= 1
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "port_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
