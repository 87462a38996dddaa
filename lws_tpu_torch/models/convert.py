"""The weight bridge: the JAX package's config and parameter tree (as numpy
arrays) to the port's `LlamaConfig` and `Llama` module, and back.

The JAX tree (lws_tpu/models/llama.py:init_params) stacks layers on a
leading axis and multiplies `x @ w` with w [in, out]; the port keeps one
module per layer and nn.Linear's [out, in], so every product weight crosses
transposed. bf16 arrives as an ml_dtypes bfloat16 array, which
torch.from_numpy rejects: it crosses as a uint16 view of the same bits.
Nothing here imports jax; a caller passes `jax.tree.map(np.asarray, params)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike
from lws_tpu_torch.models.llama import Llama, LlamaConfig

_LAYER_PRODUCTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_LAYER_NORMS = ("attn_norm", "ffn_norm")


def config_from_jax(jcfg) -> LlamaConfig:
    """The port's LlamaConfig for a lws_tpu LlamaConfig (read by attribute;
    dtypes by numpy name). Raises on a feature the port does not have yet."""
    for feature in ("n_experts", "kv_quant", "context_parallel", "pipeline_microbatches"):
        if getattr(jcfg, feature, None):
            raise ValueError(f"config_from_jax: {feature} is not ported yet")
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig)
          if f.name not in ("dtype", "param_dtype")}
    return LlamaConfig(**kw, dtype=getattr(torch, np.dtype(jcfg.dtype).name),
                       param_dtype=getattr(torch, np.dtype(jcfg.param_dtype).name))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch.from_numpy wants writable memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:  # no bf16 numpy type here: hand back the raw bits
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()


def _copy(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"weight bridge: {name} is {src.dtype}{tuple(src.shape)}, "
                         f"the port expects {dst.dtype}{tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(tree: dict, cfg: LlamaConfig, device: DeviceLike = None) -> Llama:
    """A `Llama` on `device` holding the weights of a JAX parameter tree given
    as numpy arrays. Types must already match cfg.param_dtype (no silent
    casts), so a round trip is bit-exact."""
    model = Llama(cfg, device)
    layers = tree["layers"]
    _copy(model.embed.weight, _to_torch(tree["embed"]), "embed")
    _copy(model.final_norm, _to_torch(tree["final_norm"]), "final_norm")
    _copy(model.lm_head.weight, _to_torch(tree["lm_head"]).T, "lm_head")
    for l, block in enumerate(model.layers):
        for name in _LAYER_NORMS:
            _copy(getattr(block, name), _to_torch(layers[name][l]), f"layers.{name}[{l}]")
        for name in _LAYER_PRODUCTS:
            _copy(getattr(block, name).weight, _to_torch(layers[name][l]).T,
                  f"layers.{name}[{l}]")
    return model


def params_to_numpy(model: Llama) -> dict:
    """The inverse bridge: the JAX tree layout (stacked layers, [in, out]
    products) as numpy arrays; bf16 as ml_dtypes bfloat16 where ml_dtypes is
    installed, else as its uint16 bits."""
    blocks = list(model.layers)
    layers = {name: np.stack([_to_numpy(getattr(b, name)) for b in blocks])
              for name in _LAYER_NORMS}
    layers.update({name: np.stack([_to_numpy(getattr(b, name).weight.T) for b in blocks])
                   for name in _LAYER_PRODUCTS})
    return {
        "embed": _to_numpy(model.embed.weight),
        "layers": layers,
        "final_norm": _to_numpy(model.final_norm),
        "lm_head": _to_numpy(model.lm_head.weight.T),
    }
