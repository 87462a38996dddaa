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

A group of processes serves one model tensor-parallel: parallel/ starts
torch.distributed from the control plane's env contract and forms the mesh
the engines take (`mesh=`); runtime/worker.py is the group's worker.
`python -m lws_tpu_torch loadgen` (cli.py) runs a traffic scenario against
the port's engines or a live disaggregated pair and prints the goodput
report.

The control plane that deploys these workers is ported under the JAX
package's paths (api/, core/store.py, webhooks/, sched/, controllers/,
runtime/{harness,local,server}.py, manifest.py, config.py):
`python -m lws_tpu_torch serve` runs it, with its API server, in a process
that never touches the card, and `apply|get|delete|scale|logs|events` talk
to it.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # Imported on first use: the control plane's commands (`python -m
    # lws_tpu_torch get ...`, `serve`) need no torch, and importing it costs
    # each such process seconds.
    if name == "resolve_device":
        from lws_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'lws_tpu_torch' has no attribute {name!r}")
