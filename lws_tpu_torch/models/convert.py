"""The weight bridge: the JAX package's config and parameter tree (as numpy
arrays) to the port's `LlamaConfig` and `Llama` module, and back.

The JAX tree (lws_tpu/models/llama.py:init_params) stacks layers on a
leading axis and multiplies `x @ w` with w [in, out]; the port keeps one
module per layer and nn.Linear's [out, in], so every product weight crosses
transposed. bf16 arrives as an ml_dtypes bfloat16 array, which
torch.from_numpy rejects: it crosses as a uint16 view of the same bits.
Nothing here imports jax; a caller passes `jax.tree.map(np.asarray, params)`.

A quantized tree (lws_tpu/models/quant.py:quantize_params or
flagship.init_quantized_params) has QuantizedArray leaves, read by
attribute (`.q`, `.scale`): layer products q [L, D, F] + scale [L, F] cross
as q[l].T [F, D] + scale[l] [F], lm_head q [D, V] as q.T [V, D] with scale
[V]; the per-row embedding q [V, D] + scale [V] and the norms cross as they
are. The model is then built with `quantized=True`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike
from lws_tpu_torch.models.llama import LAYER_NORMS, LAYER_PRODUCTS, Llama, LlamaConfig
from lws_tpu_torch.models.quant import QuantizedArray


def config_from_jax(jcfg) -> LlamaConfig:
    """The port's LlamaConfig for a lws_tpu LlamaConfig (read by attribute;
    dtypes by numpy name). Raises on a feature the port does not have yet."""
    for feature in ("n_experts", "context_parallel", "pipeline_microbatches"):
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


def _copy_weight(module, leaf, name: str, transpose: bool, index=None) -> None:
    """Copy a plain or quantized JAX leaf (optionally its [index] slice)
    into `module`'s weight (nn.Linear/nn.Embedding) or q/scale buffers."""
    def part(a):
        return _to_torch(a if index is None else a[index])

    if hasattr(leaf, "q"):
        q = part(leaf.q)
        _copy(module.q, q.T if transpose else q, f"{name}.q")
        _copy(module.scale, part(leaf.scale), f"{name}.scale")
    else:
        w = part(leaf)
        _copy(module.weight, w.T if transpose else w, name)


@torch.no_grad()
def params_from_jax(tree: dict, cfg: LlamaConfig, device: DeviceLike = None) -> Llama:
    """A `Llama` on `device` holding the weights of a JAX parameter tree given
    as numpy arrays, plain or quantized (QuantizedArray leaves). Types must
    already match (no silent casts), so a round trip is bit-exact."""
    model = Llama(cfg, device, quantized=hasattr(tree["embed"], "q"))
    layers = tree["layers"]
    _copy_weight(model.embed, tree["embed"], "embed", transpose=False)
    _copy(model.final_norm, _to_torch(tree["final_norm"]), "final_norm")
    _copy_weight(model.lm_head, tree["lm_head"], "lm_head", transpose=True)
    for l, block in enumerate(model.layers):
        for name in LAYER_NORMS:
            _copy(getattr(block, name), _to_torch(layers[name][l]), f"layers.{name}[{l}]")
        for name in LAYER_PRODUCTS:
            _copy_weight(getattr(block, name), layers[name], f"layers.{name}[{l}]",
                         transpose=True, index=l)
    return model


def _weight_to_numpy(module, transpose: bool):
    if hasattr(module, "q"):
        return QuantizedArray(q=_to_numpy(module.q.T if transpose else module.q),
                              scale=_to_numpy(module.scale))
    return _to_numpy(module.weight.T if transpose else module.weight)


def _stack(leaves: list):
    if isinstance(leaves[0], QuantizedArray):
        return QuantizedArray(q=np.stack([a.q for a in leaves]),
                              scale=np.stack([a.scale for a in leaves]))
    return np.stack(leaves)


def params_to_numpy(model: Llama) -> dict:
    """The inverse bridge: the JAX tree layout (stacked layers, [in, out]
    products) as numpy arrays, quantized weights as the port's
    QuantizedArray of numpy q/scale; bf16 as ml_dtypes bfloat16 where
    ml_dtypes is installed, else as its uint16 bits."""
    blocks = list(model.layers)
    layers = {name: np.stack([_to_numpy(getattr(b, name)) for b in blocks])
              for name in LAYER_NORMS}
    layers.update({name: _stack([_weight_to_numpy(getattr(b, name), True) for b in blocks])
                   for name in LAYER_PRODUCTS})
    return {
        "embed": _weight_to_numpy(model.embed, transpose=False),
        "layers": layers,
        "final_norm": _to_numpy(model.final_norm),
        "lm_head": _weight_to_numpy(model.lm_head, transpose=True),
    }
