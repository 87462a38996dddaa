"""Finding a cell's parts by name: the cell in `BENCHMARK.json`, its
configuration, traffic mix and limits files, and the per-layer metric
readers. Nothing here imports torch or the program, so the tests and the
reference can use it anywhere."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    """One `workloads` entry with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict        # the configuration file
    traffic: dict       # the traffic mix file
    limits: dict        # the cell's limits file
    end_to_end: list    # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list     # BENCHMARK.json's per_layer entries this cell reports


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the checkout's root")
    return read_json(path)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in `cell`: every cell, or those
    its `workloads` key lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json: its configuration file (the
    `file` its configs entry gives), `<pkg>/traffic/<traffic>.json` and
    `<pkg>/limits/<cell>.json`, where <pkg> is the folder of the
    configuration files' parent (port_bench/ in this repository)."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    cfg_path = root / cfg_entry["file"]
    pkg = cfg_path.parent.parent
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=read_json(cfg_path),
        traffic=read_json(pkg / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(pkg / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def metric_path(name: str, pkg: Path = PKG) -> Path:
    return pkg / "metrics" / f"{name}.py"


def load_metric(name: str, pkg: Path = PKG) -> ModuleType:
    """The reader module of per-layer metric `name`: `metrics/<name>.py`,
    loaded by path (a name may hold dots). It defines NAME, UNIT, LAYER,
    SOURCE, MOVES and `read(record) -> float | None`."""
    path = metric_path(name, pkg)
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{abs(hash(name))}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"{path}: no reader for per-layer metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if getattr(mod, "NAME", None) != name:
        raise ValueError(f"{path}: NAME is {getattr(mod, 'NAME', None)!r}, not {name!r}")
    return mod


def model_shape(config: dict) -> dict:
    """The decoder's shape from a configuration file's published keys
    (the names of the model's own config.json): what both the program's
    LlamaConfig and the reference are built from."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    head_dim = config.get("head_dim") or d // heads
    if head_dim * heads != d:
        raise ValueError("the port's decoder needs head_dim * num_attention_heads == hidden_size")
    if config.get("sliding_window") not in (None, 0):
        raise ValueError("the port's decoder has no sliding window")
    return {
        "vocab_size": config["vocab_size"],
        "d_model": d,
        "n_layers": config["num_hidden_layers"],
        "n_heads": heads,
        "n_kv_heads": config["num_key_value_heads"],
        "head_dim": head_dim,
        "d_ff": config["intermediate_size"],
        "rope_theta": float(config["rope_theta"]),
        "norm_eps": float(config["rms_norm_eps"]),
        "n_experts": int(config.get("num_local_experts", 0) or 0),
        "top_k": int(config.get("num_experts_per_tok", 2) or 2),
    }
