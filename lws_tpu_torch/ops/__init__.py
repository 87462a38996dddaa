"""Ops of the port, attention and the int8-weight product: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of lws_tpu/ops)."""


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process (each adds one
    where it launches its kernel on a CUDA tensor)."""
    from lws_tpu_torch.ops.attention import flash_attention
    from lws_tpu_torch.ops.int8_attention import int8_decode_attention
    from lws_tpu_torch.ops.int8_matmul import int8_matmul
    from lws_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_int8,
    )

    fns = {"flash_attention": flash_attention, "paged_decode_attention": paged_decode_attention,
           "paged_decode_attention_int8": paged_decode_attention_int8,
           "int8_matmul": int8_matmul, "int8_decode_attention": int8_decode_attention}
    return {name: fn.launches for name, fn in fns.items()}
