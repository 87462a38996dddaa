"""PyTorch/CUDA port of lws_tpu's compute plane, for one NVIDIA H100.

The JAX package `lws_tpu` is the reference and stays unchanged; this
package is its counterpart, module by module (models/, ops/, serving/). It
imports torch, numpy and the standard library only.

Entry points (`Llama`, `init_params`, `init_quantized_params`,
`PagedBatchEngine`, `Engine`) run on `cuda` unless the caller passes
`device="cpu"`; with no GPU and no explicit CPU device they raise. The
kernels (flash prefill, paged decode over bf16 and int8 pools, int8 decode
over a dense cache, the int8-weight product) are hand-written CUDA C++ for
sm_90a (csrc/), built by nvcc at first use (ops/_ext.py); on CPU tensors
the ops compute their plain PyTorch versions.
"""

from lws_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
