"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the GPU. A CUDA device without a usable GPU raises: the
    port never carries on on the CPU unless the caller asked for it with
    `device="cpu"`. "meta" builds shapes without storage (sizing only)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lws_tpu_torch: CUDA is not available on this machine; pass "
            "device='cpu' explicitly to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"lws_tpu_torch runs on 'cuda' or 'cpu' (or 'meta' for shapes), "
                         f"not {dev.type!r}")
    return dev
