"""Default multi-process worker workloads, driven purely by the injected env
contract: the port of lws_tpu/runtime/worker.py.

  python -m lws_tpu_torch.runtime.worker psum|tp_forward|serve_tp|serve_paged [--device cpu]
  python -m lws_tpu_torch.runtime.worker sleep [SECONDS]

Each member reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID (or the LWS_* contract under them), starts torch.distributed
with the leader as the store (parallel.initialize_from_env; a one-member
group still forms its one-rank group), and writes one result line to
$LWS_TPU_RESULT_FILE, the JAX worker's lines:

  * psum: all-reduces (process_id + 1) over the group; ok when the sum is
    n(n+1)/2;
  * tp_forward: the group forms ONE tensor-parallel mesh (one rank = one
    device, tp = group size) and runs the sharded no-cache forward of a
    small llama; every member computes the same replicated logits, whose
    checksum it reports;
  * serve_tp: the TP dense Engine prefills 2 prompts and decodes 8 steps;
    every member reports the same tokens;
  * serve_paged: the TP PagedBatchEngine with prefix caching serves a
    greedy request and an unseeded sampled one over a shared 16-token
    system prompt (2 blocks of 8 on the CPU, one of 16 on a GPU); every
    member reports the same tokens and 16 prefix-hit tokens (the sampled
    request draws from the root's broadcast entropy).

The weights come from a seeded torch.Generator (seed 7), not from JAX: the
tokens equal the port's single-process engines on the same seed, not the
JAX worker's. The device is `cuda:<process_id mod cards>` (NCCL) unless
--device names another (cpu: gloo); without a GPU and without --device cpu
it raises. On a GPU, rank 0 builds the kernels while the others wait at a
barrier (ops/_ext.py:build_on_rank_zero).
"""

from __future__ import annotations

import argparse
import os
import sys

SEED = 7


def _small_cfg(max_seq_len: int, device):
    import torch

    from lws_tpu_torch.models.llama import LlamaConfig

    # The JAX worker's geometry in f32 on the CPU; on a GPU the kernels take
    # bf16 and head_dim 128 (4 heads of 128 over d_model 512).
    if device.type == "cpu":
        return LlamaConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
                           d_ff=64, max_seq_len=max_seq_len, dtype=torch.float32,
                           param_dtype=torch.float32)
    return LlamaConfig(vocab_size=64, d_model=512, n_layers=2, n_heads=4, n_kv_heads=4,
                       d_ff=1024, max_seq_len=max_seq_len, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)


def _start(device_arg):
    """Bootstrap from the env; returns (info, this rank's device)."""
    from lws_tpu_torch.ops import _ext
    from lws_tpu_torch.parallel import initialize_from_env, local_device
    from lws_tpu_torch.parallel.bootstrap import bootstrap_info_from_env

    dev = local_device(bootstrap_info_from_env(), device_arg)
    info = initialize_from_env(device=dev, group_of_one=True)
    if dev.type == "cuda":
        _ext.build_on_rank_zero()
    return info, dev


def _model(cfg, dev):
    import torch

    from lws_tpu_torch.models.llama import init_params

    return init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)


def run_psum(device_arg=None) -> int:
    import torch
    import torch.distributed as dist

    info, dev = _start(device_arg)
    n = info.num_processes
    t = torch.tensor([float(info.process_id + 1)], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    total = float(t.item())
    expected = n * (n + 1) / 2
    ok = abs(total - expected) < 1e-6
    _write_result(f"process={info.process_id} total={total} expected={expected} ok={ok}")
    print(f"[worker {info.process_id}/{n}] psum={total} expected={expected} ok={ok}")
    return 0 if ok else 1


def run_tp_forward(device_arg=None) -> int:
    import torch

    from lws_tpu_torch.models.llama import forward, shard_params
    from lws_tpu_torch.parallel import mesh_from_bootstrap

    info, dev = _start(device_arg)
    mesh = mesh_from_bootstrap(info)
    cfg = _small_cfg(32, dev)
    params = shard_params(_model(cfg, dev), mesh)
    tokens = torch.arange(16, device=dev)[None, :]
    with torch.no_grad():
        logits, _ = forward(params, tokens)
    checksum = float(logits.abs().sum())
    line = (f"process={info.process_id}/{info.num_processes} devices={mesh.spec.size} "
            f"tp={mesh.tp} checksum={checksum:.4f}")
    _write_result(line)
    print(f"[worker] {line}")
    return 0


def run_serve_tp(device_arg=None) -> int:
    import numpy as np

    from lws_tpu_torch.parallel import mesh_from_bootstrap
    from lws_tpu_torch.serving.engine import Engine

    info, dev = _start(device_arg)
    mesh = mesh_from_bootstrap(info)
    cfg = _small_cfg(64, dev)
    engine = Engine(cfg, _model(cfg, dev), batch_size=2, max_len=64, mesh=mesh, device=dev)
    prompt = (np.arange(32, dtype=np.int32) % 64).reshape(2, 16)
    token, cache = engine.prefill(prompt)
    token, cache, toks = engine.decode_n(token, cache, 8)
    tokens = [int(t) for t in toks.cpu().numpy().ravel()]
    line = f"process={info.process_id}/{info.num_processes} tp={mesh.tp} tokens={tokens}"
    _write_result(line)
    print(f"[worker] {line}")
    return 0


def run_serve_paged(device_arg=None) -> int:
    import numpy as np

    from lws_tpu_torch.parallel import mesh_from_bootstrap
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    info, dev = _start(device_arg)
    mesh = mesh_from_bootstrap(info)
    cfg = _small_cfg(64, dev)
    # The JAX worker's blocks of 8 on the CPU; the paged kernel takes 16.
    engine = PagedBatchEngine(cfg, _model(cfg, dev), slots=2, max_len=32,
                              block_size=8 if dev.type == "cpu" else 16, mesh=mesh,
                              prefix_cache=True, device=dev)
    sys_prompt = (np.arange(16) % 64).astype(np.int32)
    a = engine.submit(np.concatenate([sys_prompt, [40, 41]]).astype(np.int32), max_new_tokens=6)
    # seed=None: each member draws its own urandom, the root's wins.
    b = engine.submit(np.concatenate([sys_prompt, [50]]).astype(np.int32), max_new_tokens=6,
                      temperature=0.8, top_k=16, seed=None)
    engine.run_until_drained()
    tokens = engine.result(a) + engine.result(b)
    line = (f"process={info.process_id}/{info.num_processes} tp={mesh.tp} "
            f"hits={engine.stats_prefix['hit_tokens']} tokens={tokens}")
    _write_result(line)
    print(f"[worker] {line}")
    return 0


def _write_result(line: str) -> None:
    """Atomic write: readers poll for the file and must never see it empty."""
    out = os.environ.get("LWS_TPU_RESULT_FILE")
    if not out:
        return
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(line + "\n")
    os.replace(tmp, out)


COMMANDS = {"psum": run_psum, "tp_forward": run_tp_forward, "serve_tp": run_serve_tp,
            "serve_paged": run_serve_paged}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else "psum"
    if cmd == "sleep":
        import time

        time.sleep(float(argv[1]) if len(argv) > 1 else 3600)
        return 0
    if cmd not in COMMANDS:
        print(f"unknown worker command {cmd!r}", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(prog="lws_tpu_torch.runtime.worker")
    ap.add_argument("--device", default=None,
                    help="this member's device (default cuda:<process_id mod cards>; cpu: gloo)")
    args = ap.parse_args(argv[1:])
    try:
        return COMMANDS[cmd](args.device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
