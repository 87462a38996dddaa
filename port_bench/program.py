"""The system under test, built for one cell: the port's LlamaConfig from
the configuration file, a `Llama(quantized=True)` holding the benchmark's
seeded weights (weights.py), and `PagedBatchEngine` with the
configuration's and the mix's engine settings, passed by name. The only
module of the harness that imports `lws_tpu_torch`."""

from __future__ import annotations

import torch

from port_bench import weights



def llama_config(shape: dict, port: dict, max_len: int):
    from lws_tpu_torch.models.llama import LlamaConfig

    if port.get("compute_dtype", "bfloat16") != "bfloat16":
        raise ValueError("the benchmark's reference and limits are set for bfloat16 compute")
    dtype = torch.bfloat16
    extra = {"capacity_factor": float(port["capacity_factor"])} if "capacity_factor" in port else {}
    return LlamaConfig(
        vocab_size=shape["vocab_size"], d_model=shape["d_model"], n_layers=shape["n_layers"],
        n_heads=shape["n_heads"], n_kv_heads=shape["n_kv_heads"], d_ff=shape["d_ff"],
        rope_theta=shape["rope_theta"], norm_eps=shape["norm_eps"], max_seq_len=max_len,
        dtype=dtype, param_dtype=dtype, n_experts=shape["n_experts"], top_k=shape["top_k"],
        remat=False, kv_quant=bool(port.get("kv_quant", False)), **extra)


@torch.no_grad()
def build_model(cfg, shape: dict, seed: int, device):
    """A Llama(quantized=True) whose buffers the weight maker fills in
    place, layer by layer, from the seed."""
    from lws_tpu_torch.models.llama import Llama

    if shape["d_model"] % shape["n_heads"] or cfg.head_dim != shape["head_dim"]:
        raise ValueError("configuration head_dim does not match the port's d_model / n_heads")
    model = Llama(cfg, device, quantized=True)
    for i, blk in enumerate(model.layers):
        dest = {}
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            w = getattr(blk, name)
            dest[f"{name}.q"], dest[f"{name}.scale"] = w.q, w.scale
        if blk.router is not None:
            dest["router"] = blk.router
        dest["attn_norm"], dest["ffn_norm"] = blk.attn_norm, blk.ffn_norm
        weights.make_layer(shape, seed, i, device, cfg.dtype, out=dest)
    weights.make_global(shape, seed, device, cfg.dtype, out={
        "embed.q": model.embed.q, "embed.scale": model.embed.scale,
        "lm_head.q": model.lm_head.q, "lm_head.scale": model.lm_head.scale,
        "final_norm": model.final_norm})
    return model


class Served:
    """The engine behind the loop's four calls."""

    def __init__(self, cfg, model, engine_kwargs: dict, device):
        from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

        self.engine = PagedBatchEngine(cfg, model, device=device, **engine_kwargs)

    def submit(self, prompt, max_new: int):
        return self.engine.submit(prompt, max_new)

    def step_n(self, n: int) -> int:
        return self.engine.step_n(n)

    def result(self, rid: int):
        return self.engine.result(rid)

    def hit_tokens(self) -> int:
        return self.engine.stats_prefix["hit_tokens"]


def compile_seconds() -> float:
    """nvcc seconds this process spent building kernels (the port's
    compile ledger, obs/device.py)."""
    from lws_tpu_torch.obs import device as devicemod

    return float(sum(r.get("seconds", 0.0) for r in devicemod.LEDGER.records()))
