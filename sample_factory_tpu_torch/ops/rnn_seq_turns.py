"""Two routes of the RNN recurrences timed in turns in one process, on the card.

    python -m sample_factory_tpu_torch.ops.rnn_seq_turns [--against OTHER_RNN_SEQ_CU]

Prints one JSON line per shape. A route's time is the median of CUDA-event timings of one launch,
each after a spin of the card (so that the interval is device time, not the host's launch work),
taken in rounds that alternate the two routes (a, b, b, a, ...):

- "waves": where the cluster plan needs more than one wave (`cuda_rnn.cluster_waves`) at a small
  width (H 64 and 128, T 16, B 512 to 4096, both kinds and dtypes), the cluster design against the
  row design: the evidence for `cuda_rnn.ROWS_OVER_WAVES_MAX_H`;
- "gates": the GRU's float32 grid sites (Doom's learner (32, 64, 512), the multichip configuration's
  (16, 4, 512), the default flags' (32, 32, 512)) against the LSTM's grid design at the same shapes:
  the LSTM fills the fourth gate column that the GRU pads with zeros;
- "build" (with --against, a copy of `csrc/rnn_seq.cu` from another commit, built beside this one):
  the float32 LSTM's grid sites (NetHack's (32, 24, 512) and (32, 32, 512), AllegroHandLSTM's
  (16, 2048, 512)), this build against the other through the same launch code.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from sample_factory_tpu_torch.ops import cuda_rnn
from sample_factory_tpu_torch.ops.rnn_seq_phases import _inputs

SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1980 MHz
ROUNDS, REPS = 4, 10
WAVES_SHAPES = [(kind, 16, B, H, dtype) for kind in ("gru", "lstm") for dtype in ("float32", "bfloat16")
                for H in (64, 128) for B in (512, 1024, 2048, 4096)]
GRU_GRID_SITES = [(32, 64, 512), (16, 4, 512), (32, 32, 512)]
LSTM_GRID_SITES = [(32, 24, 512), (32, 32, 512), (16, 2048, 512)]


def _launch_ms(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def in_turns(a, b):
    """Medians of a's and b's launch times over ROUNDS rounds of REPS launches each, in the order
    a, b, b, a, ... after a warm-up launch of each."""
    a(), b()
    times = ([], [])
    for i in range(ROUNDS):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            times[k].extend(_launch_ms((a, b)[k]) for _ in range(REPS))
    return statistics.median(times[0]), statistics.median(times[1])


def _launcher(kind, T, B, H, dtype, plan=None):
    args = _inputs(kind, T, B, H, dtype)
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    return lambda: launch(*args, plan=plan)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="another version of csrc/rnn_seq.cu: time the LSTM's grid sites with both builds")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rnn_seq_turns needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    this = cuda_rnn.load_library()
    stat = f"median of {ROUNDS} x {REPS} CUDA-event times of one launch, routes in turns"
    with torch.no_grad():
        for kind, T, B, H, dtype in WAVES_SHAPES:
            plan = cuda_rnn.cluster_plan(kind, B, H, dtype)
            if plan is None or cuda_rnn.cluster_waves(plan) < 2:
                continue
            cluster_ms, rows_ms = in_turns(_launcher(kind, T, B, H, dtype, plan), _launcher(kind, T, B, H, dtype, cuda_rnn.row_plan(kind, B, H)))
            print(json.dumps({"turns": "waves", "kernel": kind, "shape": [T, B, H], "dtype": dtype, "clusters": plan.grid // plan.cluster,
                              "waves": cuda_rnn.cluster_waves(plan), "cluster_ms": cluster_ms, "rows_ms": rows_ms,
                              "planned": cuda_rnn.launch_plan(kind, T, B, H, dtype).design, "stat": stat, "card": card}), flush=True)
        for T, B, H in GRU_GRID_SITES:
            plan = cuda_rnn.launch_plan("gru", T, B, H, "float32")
            gru_ms, lstm_ms = in_turns(_launcher("gru", T, B, H, "float32", plan), _launcher("lstm", T, B, H, "float32", plan))
            print(json.dumps({"turns": "gates", "shape": [T, B, H], "dtype": "float32", "plan": plan.__dict__, "gru_grid_ms": gru_ms,
                              "lstm_grid_ms": lstm_ms, "stat": stat, "card": card}), flush=True)
        if opts.against:
            other = cuda_rnn.bind(cuda_rnn.build(source=opts.against), entries=("lstm_grid_forward",))
            for T, B, H in LSTM_GRID_SITES:
                launch = _launcher("lstm", T, B, H, "float32")

                def using(lib):
                    def run():
                        cuda_rnn._lib = lib
                        launch()
                    return run

                this_ms, other_ms = in_turns(using(this), using(other))
                cuda_rnn._lib = this
                print(json.dumps({"turns": "build", "kernel": "lstm_seq_grid", "shape": [T, B, H], "dtype": "float32",
                                  "this_ms": this_ms, "against_ms": other_ms, "against": opts.against, "stat": stat, "card": card}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
