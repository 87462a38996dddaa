"""Model code of the port (counterpart of lws_tpu/models), with the names
JAX's package exports, each imported on first access (they import torch).
Left out: `param_shardings`, the GSPMD PartitionSpec tree JAX shards its
parameters by; the port shards by hand over NCCL (`llama.shard_params`)."""

_EXPORTS = {
    "LlamaConfig": "lws_tpu_torch.models.llama",
    "init_params": "lws_tpu_torch.models.llama",
    "forward": "lws_tpu_torch.models.llama",
    "loss_fn": "lws_tpu_torch.models.llama",
    "TrainState": "lws_tpu_torch.models.train",
    "make_train_step": "lws_tpu_torch.models.train",
    "init_train_state": "lws_tpu_torch.models.train",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
