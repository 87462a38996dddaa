"""BENCHMARK.json keeps the format its readers rely on: names, units,
lengths, keys, and every cell's metrics present."""

import json
import re

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_json_format():
    raw = (spec.ROOT / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == KEYS
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in b["command"]) and len(b["command"]) <= 32
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("port_bench/") and (spec.ROOT / c["file"]).exists()
        assert spec.read_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
        names.add(w["name"])
    assert len(names) == len(b["workloads"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", names)) <= names
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for w in names:
        cell = spec.load_cell(w)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
