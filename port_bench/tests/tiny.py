"""A cell at a size a CPU test run holds: the Mistral configuration's
keys at tiny widths, the mixes' shapes at short lengths, and the harness
driven on the CPU (the port's plain paths)."""

from __future__ import annotations

import copy
import json

from port_bench import spec

TINY_MODEL = {"vocab_size": 4096, "hidden_size": 256, "intermediate_size": 512,
              "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 64}
TINY_ENGINE = {"slots": 4, "max_len": 128, "block_size": 16, "prefix_cache": True}


def tiny_cell(config: str = "mistral-7b-v0.3-int8", traffic: str = "chat", moe: bool = False,
              limits: dict | None = None) -> spec.Cell:
    cfg = copy.deepcopy(spec.read_json(spec.PKG / "configs" / f"{config}.json"))
    cfg.update(TINY_MODEL)
    if moe:
        cfg.update({"num_local_experts": 4, "num_experts_per_tok": 2})
        cfg["port"]["capacity_factor"] = 2.0
    cfg["engine"] = dict(TINY_ENGINE)
    mix = copy.deepcopy(spec.read_json(spec.PKG / "traffic" / f"{traffic}.json"))
    mix["prompt"] |= {"median": 24, "min": 8, "max": 48}
    mix["output"] |= {"median": 8, "min": 4, "max": 16}
    limits = limits or {"limits": {"max_logit_gap": 1.0, "bad_completions": 0}}
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text()) \
        if (spec.ROOT / "BENCHMARK.json").exists() else {"per_layer": [], "end_to_end": []}
    return spec.Cell("tiny", 1, config, traffic, cfg, mix, limits,
                     bench.get("end_to_end", []), [])
