"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with an NVIDIA card. It prints one JSON line last on standard output: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer metrics, the device, and `correct` (the run
against the plain reference, `check.py`), each compared number beside its limit under "compared", which comes last;
the same numbers are the last lines of standard error. Without a card it exits 2 and prints no result. `harness.py`
says what one run does.
"""

import sys
import time

T_START = time.time()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # every build and kernel cache of the run, at fixed paths inside the checkout
# Python's compiled modules too, torch's included: the first run of a checkout writes them, every later run reads them
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def _environment() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    import torch

    from port_bench.harness import cell_plan, run_cell

    chips = cell_plan(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no run", file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    except ImportError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    result.pop("_numbers", None)
    from port_bench.harness import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
