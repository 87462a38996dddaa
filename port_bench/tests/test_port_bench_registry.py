"""A new configuration, traffic mix, cell and per-layer metric are files
the harness finds by name, with no edit to a file that is there."""

import json
import shutil

from port_bench import spec
from port_bench.harness import Record
from port_bench.traffic import Traffic


def test_the_repository_cells_load():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["source"].startswith("https://")
        assert cell.config["reduced"] == []
        assert "limits" in cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            reader = spec.load_metric(m["name"])
            assert (reader.UNIT, reader.LAYER, reader.SOURCE, reader.MOVES) == (
                m["unit"], m["layer"], m["source"], m["moves"])


def test_new_files_are_found_by_name(tmp_path):
    pkg = tmp_path / "bench_pkg"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (pkg / sub).mkdir(parents=True)
    cfg = spec.read_json(spec.PKG / "configs" / "mistral-7b-v0.3-int8.json")
    cfg["engine"]["slots"] = 32
    (pkg / "configs" / "throwaway-model.json").write_text(json.dumps(cfg))
    mix = spec.read_json(spec.PKG / "traffic" / "chat.json")
    mix["output"] = {"dist": "lognormal", "median": 20, "sigma": 0.5, "min": 20, "max": 20}
    (pkg / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (pkg / "limits" / "throwaway.cell.json").write_text(
        json.dumps({"limits": {"max_logit_gap": 1.0, "bad_completions": 0}}))
    (pkg / "metrics" / "admissions_per_s.py").write_text(
        'NAME = "admissions_per_s"\nUNIT = "1/s"\nLAYER = "admission"\n'
        'SOURCE = "host_clock"\nMOVES = "ttft_p90_ms"\n\n'
        'def read(rec):\n    return len(rec.admissions) / rec.seconds\n')
    shutil.copy(spec.PKG / "metrics" / "prefix_hit_pct.py", pkg / "metrics")
    bench = {
        "configs": [{"name": "throwaway-model", "file": "bench_pkg/configs/throwaway-model.json"}],
        "workloads": [{"name": "throwaway.cell", "config": "throwaway-model",
                       "traffic": "throwaway-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "admissions_per_s", "unit": "1/s"},
                      {"name": "prefix_hit_pct", "unit": "%", "workloads": ["other"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("throwaway.cell", root=tmp_path)
    assert cell.config["engine"]["slots"] == 32 and cell.traffic["output"]["max"] == 20
    assert cell.limits["limits"]["max_logit_gap"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["admissions_per_s"]
    reader = spec.load_metric("admissions_per_s", pkg)
    rec = Record({}, 32, 16, 2560, 0.0, 0.0, 2.0, [object()] * 6, [], [])
    assert reader.read(rec) == 3.0
    t = Traffic(cell.traffic, 32768, 32, 5)
    assert t.clients == 32 and {r.max_new for r in (t.request(c, 0) for c in range(32))} == {20}
