"""The readings that the comparison's limits were set from, on the card:

    python3 port_bench/readings.py --workload <cell> --seeds 11,12,... --control tf32|float8 [--faults half_batch,altered
    --fault-seeds 21,22,23] [--witnesses float64,exact] [--out readings.jsonl]

For each seed one run of the cell at its own sizes through the warm-up and a short window, then its numbers
(`check.py`) for the program and for the control (the reference at the precision named, in the program's place, on the
same recorded inputs), for the witness "float64" (the reference with its products in float64), and for the reference
and the program each against the witness "exact" (the whole reference in float64); then runs with each fault planted
underneath the timed path (`harness._faulty`). One JSON line a run, with every number's parts (each leaf's and each
iteration's gap), and a summary at the end: per number the largest program reading (the lower reading), the smallest
control reading and each fault's smallest reading.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WINDOW_S = 0.5  # a short window: the readings need the followed iterations, not a rate
WITNESS = "float64"  # the reference with float64 products: what rounding alone makes of each number
EXACT = "exact"  # the whole reference in float64: which of the program and the reference lies nearer the exact answer


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--witnesses", default=f"{WITNESS},{EXACT}", help="comma-separated; empty for none")
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    from port_bench.check import NUMBERS
    from port_bench.harness import run_cell

    out = open(args.out, "a") if args.out else None
    witnesses = [w for w in args.witnesses.split(",") if w]
    rows = []
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), f) for f in args.faults.split(",") if f for s in args.fault_seeds.split(",") if s]
    for seed, fault in runs:
        t = time.time()
        r = run_cell(args.workload, seed, WINDOW_S, False, fault=fault, readings=() if fault else (args.control, *witnesses))
        row = {"workload": args.workload, "seed": seed, "fault": fault, "seconds": time.time() - t,
               "metrics": r["metrics"], "readings": r.get("_readings", {"program": {"numbers": r["_numbers"]}})}
        rows.append(row)
        line = json.dumps(row)
        if out:
            out.write(line + "\n")
            out.flush()
        print(json.dumps({"seed": seed, "fault": fault, "program": row["readings"]["program"]["numbers"],
                          "control": row["readings"].get(args.control, {}).get("numbers"),
                          "witness": row["readings"].get(WITNESS, {}).get("numbers"),
                          "reference_to_exact": row["readings"].get(EXACT, {}).get("numbers"),
                          "program_to_exact": row["readings"].get(EXACT, {}).get("program", {}).get("numbers")}),
              flush=True)
    summary = {}
    for name in NUMBERS:
        if name not in rows[0]["readings"]["program"]["numbers"]:  # state_gap of a model without a recurrent state
            continue
        sound = [r["readings"]["program"]["numbers"][name] for r in rows if r["fault"] is None]
        control = [r["readings"][args.control]["numbers"][name] for r in rows if r["fault"] is None]
        witness = [r["readings"][WITNESS]["numbers"][name] for r in rows if r["fault"] is None and WITNESS in r["readings"]]
        entry = {"lower": max(sound), "control_min": min(control), "witness_max": max(witness, default=None)}
        for fault in {r["fault"] for r in rows if r["fault"]}:
            entry[f"{fault}_min"] = min(r["readings"]["program"]["numbers"][name] for r in rows if r["fault"] == fault)
        summary[name] = entry
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
