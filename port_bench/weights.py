"""The benchmark's own weight maker: random int8 weights from the seed, on
the card, in the type they are served in.

Copied from the port's `models/flagship.py:init_quantized_params` and
`chip_smoke.py:init_quantized_moe`: values uniform in [-127, 127], one f32
scale per output channel around fan_in**-0.5 / 73.3 (the rms of uniform
int8, so a dequantized weight has rms about fan_in**-0.5), wo and w_down
further damped by (2L)**-0.5, the embedding table's rows around 1 / 73.3,
the MoE router N(0, 1/d) in the compute dtype. Unlike the copies, which
give every channel the same scale and every norm weight 1, each channel's
scale is that value times U(0.5, 1.5) and each norm weight is U(0.5, 1.5),
all from the seed: a product that reads another channel's scale, or a norm
that drops its weight, then serves other tokens than the reference.

Each layer draws from a generator of its own, seeded from (seed, layer),
in a fixed order of one large call per tensor. So the reference can make
any one layer again, bit for bit, without the program's copy and without
making the others: `make_layer(shape, seed, layer, device)`. Imports torch
and numpy only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

INT8_UNIFORM_RMS = 254.0 / (12.0 ** 0.5)
JITTER = (0.5, 1.5)  # the range of each channel's scale factor and each norm weight
GLOBAL = -1  # the "layer" of the embedding table and the lm_head


def generator(seed: int, layer: int, device) -> torch.Generator:
    word = np.random.SeedSequence([int(seed) % (1 << 64), layer + 1]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def layer_names(shape: dict) -> list[tuple[str, tuple, int, float]]:
    """(name, shape of q, fan_in, damp) of a layer's int8 weights in draw
    order; experts stack as [E, out, in]."""
    d, hd, L = shape["d_model"], shape["head_dim"], shape["n_layers"]
    h, kv, f, e = shape["n_heads"], shape["n_kv_heads"], shape["d_ff"], shape["n_experts"]
    lead = (e,) if e else ()
    damp = (2 * L) ** -0.5
    return [("wq", (h * hd, d), d, 1.0), ("wk", (kv * hd, d), d, 1.0),
            ("wv", (kv * hd, d), d, 1.0), ("wo", (d, h * hd), h * hd, damp),
            ("w_gate", lead + (f, d), d, 1.0), ("w_up", lead + (f, d), d, 1.0),
            ("w_down", lead + (d, f), f, damp)]


def _jitter(shape: tuple, g: torch.Generator, device) -> torch.Tensor:
    """f32 values U(JITTER) of `shape`, drawn in f32 whatever they are kept in."""
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(*JITTER, generator=g)


def _fill(q: torch.Tensor, scale: torch.Tensor, g: torch.Generator, fan_in: int,
          damp: float) -> None:
    q.random_(-127, 128, generator=g)
    scale.copy_(_jitter(tuple(scale.shape), g, scale.device)
                * (fan_in ** -0.5 * damp / INT8_UNIFORM_RMS))


def _norm(out: dict, name: str, d: int, g: torch.Generator, device, dtype) -> None:
    w = _jitter((d,), g, device)
    if name in out:
        out[name].copy_(w)
    else:
        out[name] = w.to(dtype)


@torch.no_grad()
def make_layer(shape: dict, seed: int, layer: int, device, compute_dtype=torch.bfloat16,
               out: Optional[dict] = None) -> dict:
    """Layer `layer`'s tensors: "<name>.q" int8 and "<name>.scale" f32 for
    each product, "router" (MoE) in `compute_dtype`, "attn_norm" and
    "ffn_norm". With `out`, drawn into its tensors in place (the program's
    buffers); else into new ones."""
    out = {} if out is None else out
    g = generator(seed, layer, device)
    d, e = shape["d_model"], shape["n_experts"]
    names = layer_names(shape)
    for i, (name, qshape, fan_in, damp) in enumerate(names):
        if e and i == 4:  # the router is drawn between the attention and the experts
            r = torch.randn((e, d), generator=g, device=device, dtype=torch.float32) * d ** -0.5
            if "router" in out:
                out["router"].copy_(r)
            else:
                out["router"] = r.to(compute_dtype)
        q = out.setdefault(f"{name}.q", torch.empty(qshape, dtype=torch.int8, device=device))
        s = out.setdefault(f"{name}.scale",
                           torch.empty(qshape[:-1], dtype=torch.float32, device=device))
        _fill(q, s, g, fan_in, damp)
    for name in ("attn_norm", "ffn_norm"):
        _norm(out, name, d, g, device, compute_dtype)
    return out


@torch.no_grad()
def make_global(shape: dict, seed: int, device, compute_dtype=torch.bfloat16,
                out: Optional[dict] = None) -> dict:
    """The embedding table ("embed.q" [V, D], per-row "embed.scale"), the
    lm_head ("lm_head.q", "lm_head.scale") and "final_norm"."""
    out = {} if out is None else out
    g = generator(seed, GLOBAL, device)
    V, d = shape["vocab_size"], shape["d_model"]
    for name, fan_in in (("embed", 1), ("lm_head", d)):
        q = out.setdefault(f"{name}.q", torch.empty((V, d), dtype=torch.int8, device=device))
        s = out.setdefault(f"{name}.scale", torch.empty(V, dtype=torch.float32, device=device))
        _fill(q, s, g, fan_in, 1.0)
    _norm(out, "final_norm", d, g, device, compute_dtype)
    return out
