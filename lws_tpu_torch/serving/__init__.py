"""Serving engines of the port (counterpart of lws_tpu/serving), with the
names JAX's package exports. Each is imported on first access: every
engine imports torch, and a process that reads only the torch-free
`serving/kv_host_arena.py` (the telemetry server's /debug/prefixes) must
not pay for it."""

_EXPORTS = {
    "BatchEngine": "lws_tpu_torch.serving.batch_engine",
    "PagedBatchEngine": "lws_tpu_torch.serving.paged_engine",
    "DecodePipeline": "lws_tpu_torch.serving.pipeline",
    "Engine": "lws_tpu_torch.serving.engine",
    "GenerationResult": "lws_tpu_torch.serving.engine",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
