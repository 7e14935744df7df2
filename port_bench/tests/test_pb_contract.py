"""BENCHMARK.json against the benchmark's contract, and every part it names found by name under port_bench/."""

import json
import re
from pathlib import Path

import pytest

from port_bench.reference import observations

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"] and all(PATH.match(p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 10 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if section == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert e["file"] == f"port_bench/configs/{e['name']}.json"
            assert isinstance(e["reduced"], list) and len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
        elif section == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert NAME.match(e["traffic"]) and e["chips"] in (1, 4) and e["name"] == f"{e['config']}.{e['traffic']}"
        else:
            assert set(e) - {"workloads"} == ({"name", "unit", "better", "bound", "source"} if section == "end_to_end"
                                             else {"name", "unit", "better", "source", "layer", "moves"})
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert set(e.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and len(e2e) >= 2
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert BENCH["per_layer"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_cells_and_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert config["precision"] == config["flags"]["compute_dtype"]
        assert all(spec["store"] in ("float32", "uint8", "int32") for spec in observations(config).values())
        assert config["peak_flops"] > 0 and all(isinstance(v, (int, float)) for v in config["limits"].values())
    for w in BENCH["workloads"]:
        wl = json.loads((ROOT / "port_bench" / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["name"], wl["config"], wl["chips"], wl["why"]) == (w["name"], w["config"], w["chips"], w["why"])
        assert (ROOT / "port_bench" / "envs" / f"{wl['traffic']['env']}.py").is_file()
