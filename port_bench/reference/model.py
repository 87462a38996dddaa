"""Plain float32 reference of the Mistral and Mixtral decoders, as their
published descriptions give them (the models' config.json and the
transformers implementations of "mistral" and "mixtral"):

    x = embed[tokens]
    per layer:  h = RMSNorm(x);  q, k, v = h Wq^T, h Wk^T, h Wv^T
                rotate-half RoPE (theta) on q and k at positions 0..T-1
                causal grouped-query attention (softmax(q k^T / sqrt(hd)) v)
                x = x + attn Wo^T;  h = RMSNorm(x)
                dense:  x = x + (silu(h Wg^T) * (h Wu^T)) Wd^T
                MoE:    p = softmax(h R^T); the top-k experts by p, weighted
                        by p renormalised over them; x = x + sum of
                        w_e * (silu(h Wg_e^T) * (h Wu_e^T)) Wd_e^T
    logits = RMSNorm(x) lm_head^T

with the configuration's stated precisions: int8 weights dequantized to
f32 (q * scale), and, where the configuration keeps the K/V cache in int8,
K and V rounded through int8 with one scale per (token, kv head) of
amax / 127 before attention. Everything else is f32 with TF32 off.

It is given the weights by the benchmark's weight maker (port_bench.weights,
from the seed), never the program's copy, and makes each layer again from
the seed when it needs it: the layers run one at a time over every
sequence, so a layer's f32 weights (5.6 GB for a Mixtral layer) are the
largest thing it holds.

`precision="int4"` is the control: the same forward with every int8 weight
rounded to int4 (one scale per output channel of amax / 7) first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import weights

QUERY_BLOCK = 1024  # attention rows computed at once


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant(q: torch.Tensor, scale: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 [.., out, in] of an int8 weight with per-output-channel scales;
    with "int4", rounded to 15 levels per output channel first."""
    w = q.float() * scale.unsqueeze(-1)
    if precision == "int8":
        return w
    if precision != "int4":
        raise ValueError(f"unknown precision {precision!r}")
    s4 = torch.clamp(w.abs().amax(dim=-1, keepdim=True), min=1e-12) / 7.0
    return torch.clamp(torch.round(w / s4), -7, 7) * s4


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1, rotate-half convention."""
    T, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1).float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """x [..., hd] through int8 with one scale per row of hd: amax / 127,
    rounded half to even, clamped to [-127, 127]."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q [T, H, hd], k/v [T, Hkv, hd] -> [T, H * hd]."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)  # [H, T, hd]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty(T, H, hd, dtype=torch.float32, device=q.device)
    keys = torch.arange(T, device=q.device)
    for a in range(0, T, QUERY_BLOCK):
        b = min(T, a + QUERY_BLOCK)
        s = torch.matmul(q[a:b].transpose(0, 1), k.transpose(1, 2)) * hd ** -0.5  # [H, b-a, T]
        s = s.masked_fill(keys[None, None, :] > torch.arange(a, b, device=q.device)[None, :, None],
                          float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1), v).transpose(0, 1)
    return out.reshape(T, H * hd)


def swiglu(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor):
    return (F.silu(h @ wg.T) * (h @ wu.T)) @ wd.T


def moe(h: torch.Tensor, router: torch.Tensor, wg, wu, wd, top_k: int) -> torch.Tensor:
    """h [N, D]; router [E, D]; experts [E, out, in]."""
    p = torch.softmax(h @ router.float().T, dim=-1)
    top_p, top_i = torch.topk(p, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(router.shape[0]):
        rows, which = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            out.index_add_(0, rows, top_p[rows, which, None] * swiglu(h[rows], wg[e], wu[e], wd[e]))
    return out


@torch.no_grad()
def logits(shape: dict, seed: int, sequences: Sequence[np.ndarray], first: Sequence[int],
           device, kv_int8: bool = True, precisions: Sequence[str] = ("int8",)
           ) -> dict[str, list[torch.Tensor]]:
    """For each precision, each sequence's f32 logits [T - first, V] at
    positions first..T-1 (the rows that predict tokens first+1..T).
    All precisions run in one pass over the layers, each layer made once."""
    _no_tf32()
    eps, theta = shape["norm_eps"], shape["rope_theta"]
    H, Hkv, hd = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    glob = weights.make_global(shape, seed, device)
    toks = [torch.as_tensor(np.asarray(s, dtype=np.int64), device=device) for s in sequences]
    xs = {}
    for p in precisions:
        emb = dequant(glob["embed.q"], glob["embed.scale"], p)
        xs[p] = [emb[t] for t in toks]
        del emb
    for layer in range(shape["n_layers"]):
        w8 = weights.make_layer(shape, seed, layer, device)
        for p in precisions:
            w = {n: dequant(w8[f"{n}.q"], w8[f"{n}.scale"], p)
                 for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
            for i, x in enumerate(xs[p]):
                T = x.shape[0]
                h = rms_norm(x, w8["attn_norm"], eps)
                q = rope((h @ w["wq"].T).reshape(T, H, hd), theta)
                k = rope((h @ w["wk"].T).reshape(T, Hkv, hd), theta)
                v = (h @ w["wv"].T).reshape(T, Hkv, hd)
                if kv_int8:
                    k, v = int8_round_trip(k), int8_round_trip(v)
                x = x + attention(q, k, v) @ w["wo"].T
                h = rms_norm(x, w8["ffn_norm"], eps)
                if shape["n_experts"]:
                    x = x + moe(h, w8["router"], w["w_gate"], w["w_up"], w["w_down"],
                                shape["top_k"])
                else:
                    x = x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
                xs[p][i] = x
            del w
        del w8
    out = {}
    for p in precisions:
        head = dequant(glob["lm_head.q"], glob["lm_head.scale"], p)
        out[p] = [rms_norm(x[f:], glob["final_norm"], eps) @ head.T for x, f in zip(xs[p], first)]
        del head
    return out
