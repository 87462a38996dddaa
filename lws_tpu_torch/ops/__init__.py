"""Ops of the port, attention and the int8-weight product: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of lws_tpu/ops)."""
