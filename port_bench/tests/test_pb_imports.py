"""Nothing that the harness or the reference loads is JAX, flax, optax or the JAX package (top-level module names
compared whole: the port's name begins with the JAX package's), and the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sample_factory_tpu", "sf_examples_tpu"}


def loaded_after(code: str, tmp: Path):
    (tmp / "home").mkdir()
    (tmp / "tmp").mkdir()
    script = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
{code}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "HOME": str(tmp / "home"),
                              "TMPDIR": str(tmp / "tmp")})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    names = loaded_after("""
import torch
torch.set_num_threads(2)
import os, tempfile
made, mkdtemp = [], tempfile.mkdtemp
tempfile.mkdtemp = lambda *a, **k: made.append(mkdtemp(*a, **k)) or made[-1]
from port_bench.harness import run_cell
from port_bench.tests.tiny import tiny
run_cell("grid_gru256.ppo16k", 7, 0.2, False, device="cpu", overrides=tiny("grid_gru256.ppo16k"))
assert made and all(m.startswith(os.environ["TMPDIR"] + os.sep) for m in made), made
""", tmp_path)
    assert "sample_factory_tpu_torch" in names
    assert not names & FORBIDDEN
    assert not list((tmp_path / "tmp").glob("port_bench_*"))  # the run's train_dir, made under TMPDIR, is removed


def test_reference_loads_nothing_of_the_port(tmp_path):
    # every module of reference/, a configuration's own reference among them, is held to the rule
    modules = sorted(p.stem for p in (ROOT / "port_bench" / "reference").glob("*.py") if p.stem != "__init__")
    assert {"learner", "model"} <= set(modules)
    names = loaded_after(f"""
import importlib
for name in {modules!r}:
    importlib.import_module("port_bench.reference." + name)
import port_bench.check, port_bench.flops, port_bench.roofline, port_bench.trace
""", tmp_path)
    assert not names & (FORBIDDEN | {"sample_factory_tpu_torch"})
