"""run.py on a machine without a card exits non-zero and prints no result; so does a directory that holds only
BENCHMARK.json and port_bench/."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["port_bench/run.py", "--workload", "allegro_lstm512.ppo16k", "--seed", "2147483901", "--seconds", "1", "--trace", "0"]


def run_in(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(cwd)})


def test_no_card_no_result():
    out = run_in(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_in(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
