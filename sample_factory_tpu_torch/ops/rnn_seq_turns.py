"""Two routes of the RNN recurrences timed in turns in one process, on the card.

    python -m sample_factory_tpu_torch.ops.rnn_seq_turns [--against OTHER_RNN_SEQ_CU]
    python -m sample_factory_tpu_torch.ops.rnn_seq_turns --sms N
    python -m sample_factory_tpu_torch.ops.rnn_seq_turns --resident
    python -m sample_factory_tpu_torch.ops.rnn_seq_turns --resident-in

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
  (16, 2048, 512)), this build against the other through the same launch code;
- "resident" (with --resident alone): the LSTM at DMLab's instruction-encoder sites (`RESIDENT_SITES`: a rollout slot's
  (16, 64, 64), the last-value pass's (16, 128, 64), a learner minibatch's (16, 1024, 64), all float32, and (16, 2048, 64)
  in bf16) and below 64 rows ((16, 8, 64), (16, 24, 64) float32, which no path runs), the resident design (`cuda_rnn.resident_plan`) against the row design, forward and backward (the backward's
  recurrence kernel alone, on the inputs its prologue makes), and the forward against the cluster plan where there is
  one, each held against the plain version: the evidence for where `cuda_rnn.launch_plan` takes the resident design;
- "resident_in" (with --resident-in alone): `lstm_seq_in`'s kernels at DMLab's instruction-encoder sites (the first four of
  `RESIDENT_SITES`, an input of IN_WIDTH): the forward with the input product folded in against the resident kernel alone on
  x_proj, against the unfused route (the Linear, then that kernel) and against itself writing the backward's buffers; the
  backward on those buffers against the resident backward on the same proj, which recomputes the cell states;
- "sms" (with --sms alone): the paths' sites (`SPEC_SITES`: the grid sites and the cluster sites), the plan
  `cuda_rnn.launch_plan` makes for a card of N SMs (`scaled_spec`: this card's clusters of 8 and 16 scaled
  by N over its SMs, rounded down, and its shared memory) against the plan for this card's own spec
  (`cuda_rnn.card_spec`), each held against the plain version. Both run on this card: it tells what a
  smaller card's plan costs where every SM of this one is there to run it.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

from sample_factory_tpu_torch.ops import cuda_rnn
from sample_factory_tpu_torch.ops.rnn_seq_phases import IN_WIDTH, _in_inputs, _inputs

SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1980 MHz
ROUNDS, REPS = 4, 10
WAVES_SHAPES = [(kind, 16, B, H, dtype) for kind in ("gru", "lstm") for dtype in ("float32", "bfloat16")
                for H in (64, 128) for B in (512, 1024, 2048, 4096)]
GRU_GRID_SITES = [(32, 64, 512), (16, 4, 512), (32, 32, 512)]
LSTM_GRID_SITES = [(32, 24, 512), (32, 32, 512), (16, 2048, 512)]
# the paths' sites: the grid sites, then the cluster sites (main, lstm, selfplay, the DMLab core and the
# instruction encoder in a rollout slot, a minibatch and the last-value pass), (kind, T, B, H, dtype)
SPEC_SITES = ([("gru", *shape, "float32") for shape in GRU_GRID_SITES] + [("lstm", *shape, "float32") for shape in LSTM_GRID_SITES]
              + [("gru", 32, 512, 256, "bfloat16"), ("lstm", 32, 128, 256, "float32"), ("gru", 32, 512, 512, "bfloat16"),
                 ("lstm", 32, 32, 256, "float32"), ("lstm", 16, 64, 64, "float32"), ("lstm", 16, 1024, 64, "float32"),
                 ("lstm", 16, 128, 64, "float32")])
RESIDENT_SITES = [(16, 64, 64, "float32"), (16, 128, 64, "float32"), (16, 1024, 64, "float32"), (16, 2048, 64, "bfloat16"),
                  (16, 8, 64, "float32"), (16, 24, 64, "float32")]


def _launch_ms(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def in_turns(a, b, spread=False):
    """Medians of a's and b's launch times over ROUNDS rounds of REPS launches each, in the order
    a, b, b, a, ... after a warm-up launch of each; with `spread`, also each route's spread: the largest
    less the smallest of its rounds' medians."""
    a(), b()
    rounds = ([], [])
    for i in range(ROUNDS):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            rounds[k].append([_launch_ms((a, b)[k]) for _ in range(REPS)])
    medians = tuple(statistics.median([t for r in route for t in r]) for route in rounds)
    if not spread:
        return medians
    return medians + tuple(max(map(statistics.median, route)) - min(map(statistics.median, route)) for route in rounds)


def _launcher(kind, T, B, H, dtype, plan=None):
    args = _inputs(kind, T, B, H, dtype)
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    return lambda: launch(*args, plan=plan)


def scaled_spec(own: cuda_rnn.CardSpec, sms: int) -> cuda_rnn.CardSpec:
    """A card of `sms` SMs with `own`'s clusters scaled by sms / own.sms (rounded down) and its shared memory."""
    return cuda_rnn.CardSpec(sms, own.clusters_of_8 * sms // own.sms, own.clusters_of_16 * sms // own.sms, own.smem_limit)


def against_spec(spec, sites=SPEC_SITES):
    """For each site (kind, T, B, H, dtype): the plan for `spec` and the plan for this card's own spec, both
    launched on this card in turns, and the largest difference of the first's outputs (outs and the final
    state) from the plain version's. Yields one dict a site."""
    own = cuda_rnn.card_spec(torch.device("cuda"))
    reference = {"gru": cuda_rnn.gru_seq_reference, "lstm": cuda_rnn.lstm_seq_reference}
    for kind, T, B, H, dtype in sites:
        plan, own_plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, spec), cuda_rnn.launch_plan(kind, T, B, H, dtype, own)
        args = _inputs(kind, T, B, H, dtype)
        launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
        with torch.no_grad():
            out, state = launch(*args, plan=plan)
            ref_out, ref_state = reference[kind](*args)
            err = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
            ms, own_ms = in_turns(lambda: launch(*args, plan=plan), lambda: launch(*args, plan=own_plan))
        yield {"kernel": cuda_rnn._kernel_name(kind, plan), "shape": [T, B, H], "dtype": dtype, "sms": spec.sms,
               "spec": dataclasses.asdict(spec), "design": plan.design, "blocks": plan.grid, "threads": plan.threads,
               "smem": plan.smem, "plan": dataclasses.asdict(plan), "max_abs_err": err, "ms": ms,
               "own_sms": own.sms, "own_plan": dataclasses.asdict(own_plan), "own_ms": own_ms, "same_plan": plan == own_plan}


def resident_turns(spec, sites=RESIDENT_SITES):
    """For each LSTM site (T, B, H, dtype): the resident plan in turns with the row design, forward and backward, and with
    the cluster plan where one exists, the forward, warm (the forward's turns with each route's spread over its rounds); the largest difference of each resident output from the plain version's (the
    forward's outs and final state; the backward's d_x_proj and d_hc0, relative to the largest gradient). One dict a site."""
    from sample_factory_tpu_torch.ops.rnn_seq_phases import _bwd_inputs

    for T, B, H, dtype in sites:
        fwd = cuda_rnn.resident_plan("lstm", B, H, dtype, spec)
        bwd = cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True)
        cluster = cuda_rnn.cluster_plan("lstm", B, H, dtype, spec)
        args = _inputs("lstm", T, B, H, dtype)
        rec = _bwd_inputs("lstm", T, B, H, dtype)
        itemsize = 2 if dtype == "bfloat16" else 4
        others = {"rows": (cuda_rnn.row_plan("lstm", B, H),
                           cuda_rnn.bwd_row_plan("lstm", B, H, cuda_rnn.bwd_rows("lstm", B, H, dtype, spec), itemsize))}
        if cluster is not None:
            others["cluster"] = (cluster, None)
        with torch.no_grad():
            out, state = cuda_rnn._launch_lstm(*args, plan=fwd)
            ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
            got, want = cuda_rnn._launch_lstm_bwd(*rec, plan=bwd), cuda_rnn.lstm_seq_bwd_reference(*rec)
            torch.cuda.synchronize()
            record = {"shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(fwd), "bwd_plan": dataclasses.asdict(bwd),
                      "max_abs_err": max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max())),
                      "bwd_rel_err": max(float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max()))
                                         for g, w in zip(got, want))}
            for name, (other_fwd, other_bwd) in others.items():
                (record[f"ms_against_{name}"], record[f"{name}_ms"], record[f"spread_against_{name}"],
                 record[f"{name}_spread"]) = in_turns(lambda: cuda_rnn._launch_lstm(*args, plan=fwd),
                                                      lambda: cuda_rnn._launch_lstm(*args, plan=other_fwd), spread=True)
                if other_bwd is not None:
                    record[f"bwd_ms_against_{name}"], record[f"{name}_bwd_ms"] = in_turns(
                        lambda: cuda_rnn._launch_lstm_bwd(*rec, plan=bwd), lambda: cuda_rnn._launch_lstm_bwd(*rec, plan=other_bwd))
            if cluster is not None:  # the forward alone: the sites of one wave run under no_grad (a rollout, the last value)
                record["cluster_plan"], record["cluster_waves"] = dataclasses.asdict(cluster), cuda_rnn.cluster_waves(cluster, spec)
        yield record


def resident_in_turns(spec, sites=RESIDENT_SITES[:4]):
    """For each LSTM site (T, B, H, dtype), `lstm_seq_in`'s kernel (the resident design with the input product folded in), under
    no_grad, in turns with the resident kernel alone on x_proj, with the unfused route (the Linear that makes x_proj, then that
    kernel) and with itself writing the backward's buffers; the backward on the saved buffers (`lstm_seq_resident_in_bwd`, the
    cell-state pass skipped) in turns with the resident backward on the same proj (`lstm_seq_resident_bwd`, the pass run).
    Each output's largest difference from its plain version, relative to its largest value. One dict a site."""
    for T, B, H, dtype in sites:
        x, wi, bi, hc0, resets, wh = args = _in_inputs(T, B, H, dtype)
        plan = cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, dtype, spec)
        bwd = cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True)
        with torch.no_grad():
            x_proj = (x @ wi + bi).contiguous()
            out, state, proj, cells, xh = cuda_rnn._launch_lstm_in(*args, save=True, plan=plan)
            ref = cuda_rnn.lstm_seq_in_saved_reference(*args)
            d_out = torch.randn(T, B, H, device="cuda")
            d_state = torch.randn(B, 2 * H, device="cuda")
            got = cuda_rnn._launch_lstm_in_bwd(d_out, d_state, resets, proj, hc0, wh, cells, plan=bwd)
            want = cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, resets, proj, hc0, wh, cells)
            torch.cuda.synchronize()
            errs = {name: float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))
                    for name, a, b in zip(("outs", "hc_final", "proj", "cells", "xh"), (out, state, proj, cells, xh), ref)}
            errs["bwd"] = max(float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max())) for g, w in zip(got, want))
            record = {"shape": [T, B, H], "input": IN_WIDTH, "dtype": dtype, "plan": dataclasses.asdict(plan), "rel_err": errs}
            fused = lambda: cuda_rnn._launch_lstm_in(*args, plan=plan)  # noqa: E731
            record["ms_against_kernel_alone"], record["kernel_alone_ms"], record["spread"], record["kernel_alone_spread"] = in_turns(
                fused, lambda: cuda_rnn._launch_lstm(x_proj, hc0, resets, wh), spread=True)
            record["ms_against_unfused_route"], record["unfused_route_ms"] = in_turns(
                fused, lambda: cuda_rnn._launch_lstm((x @ wi + bi).contiguous(), hc0, resets, wh))
            record["ms_against_saving"], record["saving_ms"] = in_turns(
                fused, lambda: cuda_rnn._launch_lstm_in(*args, save=True, plan=plan))
            record["bwd_ms"], record["bwd_with_pass_ms"] = in_turns(
                lambda: cuda_rnn._launch_lstm_in_bwd(d_out, d_state, resets, proj, hc0, wh, cells, plan=bwd),
                lambda: cuda_rnn._launch_lstm_bwd(d_out, d_state, resets, proj, hc0, wh, plan=bwd))
        yield record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="another version of csrc/rnn_seq.cu: time the LSTM's grid sites with both builds")
    parser.add_argument("--sms", type=int, help="time the plans for a card of this many SMs against this card's own, alone")
    parser.add_argument("--resident", action="store_true", help="time the LSTM's resident design at DMLab's sites, alone")
    parser.add_argument("--resident-in", action="store_true", help="time lstm_seq_in's kernels at DMLab's sites, alone")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rnn_seq_turns needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    this = cuda_rnn.load_library()
    stat = f"median of {ROUNDS} x {REPS} CUDA-event times of one launch, routes in turns"
    if opts.resident:
        for record in resident_turns(cuda_rnn.card_spec(torch.device("cuda"))):
            print(json.dumps({"turns": "resident", **record, "stat": stat, "card": card}), flush=True)
        return 0
    if opts.resident_in:
        for record in resident_in_turns(cuda_rnn.card_spec(torch.device("cuda"))):
            print(json.dumps({"turns": "resident_in", **record, "stat": stat, "card": card}), flush=True)
        return 0
    if opts.sms:
        for record in against_spec(scaled_spec(cuda_rnn.card_spec(torch.device("cuda")), opts.sms)):
            print(json.dumps({"turns": "sms", **record, "stat": stat, "card": card}), flush=True)
        return 0
    own = cuda_rnn.card_spec(torch.device("cuda"))
    with torch.no_grad():
        for kind, T, B, H, dtype in WAVES_SHAPES:
            plan = cuda_rnn.cluster_plan(kind, B, H, dtype, own)
            if plan is None or cuda_rnn.cluster_waves(plan, own) < 2:
                continue
            cluster_ms, rows_ms = in_turns(_launcher(kind, T, B, H, dtype, plan), _launcher(kind, T, B, H, dtype, cuda_rnn.row_plan(kind, B, H)))
            print(json.dumps({"turns": "waves", "kernel": kind, "shape": [T, B, H], "dtype": dtype, "clusters": plan.grid // plan.cluster,
                              "waves": cuda_rnn.cluster_waves(plan, own), "cluster_ms": cluster_ms, "rows_ms": rows_ms,
                              "planned": cuda_rnn.launch_plan(kind, T, B, H, dtype, own).design, "stat": stat, "card": card}), flush=True)
        for T, B, H in GRU_GRID_SITES:
            plan = cuda_rnn.launch_plan("gru", T, B, H, "float32", own)
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
