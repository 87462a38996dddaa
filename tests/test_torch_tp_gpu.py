"""Tensor parallelism on several cards: one NCCL rank per card, spawned with
lws_tpu_torch.parallel.launch and bootstrapped from the env contract.

These tests need NVIDIA GPUs with nvcc (sm_90a), four of them (tp = 4):
they skip elsewhere. Like tests/test_torch_kernels_gpu.py the file imports
neither jax nor the JAX package; run it on a four-card machine with

    python -m pytest --noconftest -m gpu tests/test_torch_tp_gpu.py

  * expert parallelism at the int8 Mixtral-8x7B geometry of chip_smoke.py's
    path 11 (32 layers, 8 experts, top-2, int8 weights and KV): each rank
    holds 2 of the 8 experts of every layer. The TP prefill logits are held
    to the single-card model's (rank 0 keeps it) within chip_smoke's
    LOGITS_REL_TOL; the TP PagedBatchEngine's streams are identical on
    every rank and equal the single-card engine's, or fork only at a
    near-tie (chip_smoke.check_greedy_chain); each rank's launches are the
    single-card formula over its own experts (chip_smoke.moe_launches);
  * the vocabulary-sharded lm_head at tp = 4: 128,256 / 4 = 32,064 rows a
    rank, 250.5 tiles of 128 (the first ragged last tile the int8_matmul
    kernel meets on this path), at every row count the engines give the
    head; each rank's product is held to int8_matmul's plain version, and
    the all-gathered logits to the full head's plain product;
  * the disaggregated handoff under a tp = 2 mesh: the head gather and
    scatter over NCCL (two cards), and the two-role pair of chip_smoke.py's
    path 16 with each role on two cards.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lws_tpu_torch.parallel import launch

pytestmark = pytest.mark.gpu
TP = 4
TOL = 2e-2


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < TP:
        pytest.skip(f"needs {TP} CUDA GPUs; on a {TP}-card machine run: "
                    "python -m pytest --noconftest -m gpu tests/test_torch_tp_gpu.py")
    return TP


def _start():
    from lws_tpu_torch.ops import _ext
    from lws_tpu_torch.parallel import initialize_from_env, local_device, mesh_from_bootstrap
    from lws_tpu_torch.parallel.bootstrap import bootstrap_info_from_env

    dev = local_device(bootstrap_info_from_env())
    info = initialize_from_env(device=dev)
    _ext.build_on_rank_zero()
    return dev, mesh_from_bootstrap(info)


def _repo_on_path():
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)


def _moe_member(rank: int, out_dir: str) -> None:
    _repo_on_path()
    import chip_smoke as cs
    import torch.distributed as dist

    from lws_tpu_torch.models.llama import forward_prefill, init_cache, moe_capacity, shard_params
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    dev, mesh = _start()
    cfg = cs.mixtral_config(torch)
    V, L, E = cfg.vocab_size, cfg.n_layers, cfg.n_experts
    full = cs.init_quantized_moe(torch, cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in (100, 400, 700, 1000)]
    new = 16

    def serve(model, m):
        eng = PagedBatchEngine(cfg, model, slots=len(prompts), max_len=cs.MAX_LEN,
                               block_size=cs.BLOCK, mesh=m, device=dev)
        cs.reset_counts()
        ids = [eng.submit(p, new) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        return [eng.result(i) for i in ids], cs.read_counts(), eng.stats["decode_steps"]

    toks = torch.tensor(prompts[1][None], device=dev).long()
    ref = want = None
    if rank == 0:  # the single-card reference, while the full model is here
        ref, _ = forward_prefill(full, toks, init_cache(cfg, 1, toks.shape[1], dev))
        want, _, _ = serve(full, None)
    model = shard_params(full, mesh)
    if rank != 0:
        del full
        torch.cuda.empty_cache()
    logits, _ = forward_prefill(model, toks, init_cache(cfg, 1, toks.shape[1], dev, mesh))
    got, launches, steps = serve(model, mesh)
    rec = {"streams": got, "launches": launches, "steps": steps,
           "experts": int(model.layers[0].w_gate.q.shape[0])}
    if rank == 0:
        rec["logits_rel"] = ((logits - ref).abs().max() / ref.abs().max()).item()
        rec["forks"] = []
        for p, g, w in zip(prompts, got, want):
            i = cs.first_difference(g, w)
            if i < len(w):
                gap = cs.check_greedy_chain(torch, dev, cfg, full, p[None], np.asarray(g, np.int32),
                                            "tp MoE engine")
                rec["forks"].append((i, gap))
    cap = lambda S: moe_capacity(cfg.capacity_factor, S, cfg.top_k, E)  # noqa: E731
    local = dataclasses.replace(cfg, n_experts=E // mesh.tp)
    rec["want_launches"] = {
        "flash_attention": L * len(prompts),
        "paged_decode_attention_int8": L * steps,
        "int8_matmul": cs.moe_launches(local, [(cs.bucket_of(len(p)), cap(cs.bucket_of(len(p))))
                                               for p in prompts], steps,
                                       (len(prompts), len(prompts) * cap(1))),
    }
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def test_moe_expert_parallel_at_mixtral_geometry(cards, tmp_path):
    _repo_on_path()
    import chip_smoke as cs

    ctx, _ = launch.spawn_group(_moe_member, cards, args=(str(tmp_path),))
    launch.join(ctx, timeout_s=1200)
    recs = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(cards)]
    assert recs[0]["logits_rel"] <= cs.LOGITS_REL_TOL, recs[0]["logits_rel"]
    for rec in recs:
        assert rec["experts"] == 8 // cards
        assert rec["streams"] == recs[0]["streams"]
        got = {k: v for k, v in rec["launches"].items() if v}
        assert got == rec["want_launches"], (got, rec["want_launches"])
    print(f"tp={cards} MoE: prefill logits rel err {recs[0]['logits_rel']:.3e}; "
          f"forks at near-ties (step, gap): {recs[0]['forks']}")


def _head_member(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
    from lws_tpu_torch.parallel.collectives import all_gather

    dev, mesh = _start()
    V, D = 128256, 4096
    g = torch.Generator(device=dev).manual_seed(0)  # the same full head on every rank
    q = torch.randint(-127, 128, (V, D), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand(V, generator=g, device=dev) * D**-0.5 / 73.3
    n = V // mesh.tp
    lo = mesh.tp_rank * n
    q_l, s_l = q[lo:lo + n].contiguous(), scale[lo:lo + n].contiguous()
    rec = {"rows": n, "local_err": {}, "gathered_err": {}}
    for m in (1, 8, 40, 256):  # admission, decode, verify and bucket rows
        x = torch.randn(m, D, generator=g, device=dev, dtype=torch.bfloat16)
        local = int8_matmul(x, q_l, s_l)
        plain = int8_matmul_reference(x, q_l, s_l)
        mag = plain.float().abs().max().item()
        rec["local_err"][m] = (local.float() - plain.float()).abs().max().item() / mag
        with torch.no_grad():  # as the engines' lm_head gathers
            gathered = all_gather(local, mesh.tp_group)
        full = int8_matmul_reference(x, q, scale)
        rec["gathered_err"][m] = (gathered.float() - full.float()).abs().max().item() / \
            full.float().abs().max().item()
        rec["shape"] = list(gathered.shape)
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def test_vocab_sharded_lm_head_ragged_tile_at_tp4(cards, tmp_path):
    ctx, _ = launch.spawn_group(_head_member, cards, args=(str(tmp_path),))
    launch.join(ctx, timeout_s=600)
    for r in range(cards):
        rec = json.loads((tmp_path / f"{r}.json").read_text())
        assert rec["rows"] == 32064 and rec["shape"][1] == 128256
        for m, err in rec["local_err"].items():
            assert err <= TOL, (r, m, err)
        for m, err in rec["gathered_err"].items():
            assert err <= TOL, (r, m, err)


def _handoff_member(rank: int, out_dir: str) -> None:
    """A rank of a tp = 2 NCCL group: the handoff's device seams on given
    bf16 rows at the flagship's KV geometry, and the broadcast of a host
    object (what the TP workers' prefix tier and reshard broadcast)."""
    _repo_on_path()
    import hashlib

    import torch.distributed as dist

    from lws_tpu_torch.models.llama import KVCache
    from lws_tpu_torch.parallel.collectives import broadcast_object
    from lws_tpu_torch.serving import kv_transport as kt

    dev, mesh = _start()
    g = torch.Generator(device="cpu").manual_seed(7)
    L, T, Hkv, hd, pos = 32, 1000, 8, 128, 987
    full = {n: torch.randn(L, 1, T, Hkv, hd, generator=g).to(torch.bfloat16) for n in ("k", "v")}
    h = Hkv // mesh.tp
    mine = {n: t[:, :, :, mesh.tp_rank * h:(mesh.tp_rank + 1) * h].to(dev) for n, t in full.items()}
    cache = KVCache(k=mine["k"], v=mine["v"], pos=pos)
    bundle = kt.cache_to_bundle(cache, torch.tensor([42], dtype=torch.int32, device=dev),
                                mesh=mesh)
    single = kt.cache_to_bundle(KVCache(k=full["k"], v=full["v"], pos=pos),
                                torch.tensor([42], dtype=torch.int32))
    rec = {"gathered_equal": None if bundle is None else bundle == single}
    placed, token = kt.bundle_to_cache(single if mesh.tp_rank == 0 else None, max_len=2048,
                                       device=dev, mesh=mesh)
    rec["placed_equal"] = all(torch.equal(getattr(placed, n)[:, :, :pos].cpu(),
                                          mine[n][:, :, :pos].cpu()) for n in ("k", "v"))
    rec["placed_shape"] = list(placed.k.shape)
    rec["token"] = token.tolist()
    rec["broadcast"] = broadcast_object({"rank0": hashlib.sha256(single).hexdigest()}
                                        if mesh.tp_rank == 0 else None, mesh.tp_group)
    rec["digest"] = hashlib.sha256(single).hexdigest()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def test_tp2_handoff_seams_over_nccl(tmp_path):
    """cache_to_bundle(mesh=) gathers the ranks' KV heads over NCCL into the
    single-device bundle byte for byte (on tp rank 0), and
    bundle_to_cache(mesh=) scatters it back, each rank placing exactly its
    heads, at the flagship's KV geometry and a 1,000-row prompt."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA GPUs")
    ctx, _ = launch.spawn_group(_handoff_member, 2, args=(str(tmp_path),))
    launch.join(ctx, timeout_s=600)
    recs = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(2)]
    assert recs[0]["gathered_equal"] is True and recs[1]["gathered_equal"] is None
    for rec in recs:
        assert rec["placed_equal"] and rec["placed_shape"] == [32, 1, 2048, 4, 128]
        assert rec["token"] == [42] and rec["broadcast"] == {"rank0": rec["digest"]}


def test_tp2_disaggregated_pair_on_four_cards(cards):
    """chip_smoke.py's path 16 at tp = 2: the prefill role on cards 0-1 and
    the decode role on 2-3, each a real worker process with a spawned
    second rank, the full flagship, over loopback TCP; held to one-card
    handoffs of the same prompts (bundle bytes, tokens up to argmax
    near-ties, launches, the drain)."""
    _repo_on_path()
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    from lws_tpu_torch.ops import _ext

    _ext.build(sorted(p.stem for p in _ext.CSRC_DIR.glob("*.cu")))
    refs = cs.pair_refs(torch, dev)
    torch.cuda.empty_cache()
    launches = cs.path_tp_disagg(torch, dev, 2, refs)
    assert launches["flash_attention"] > 0 and launches["int8_matmul"] > 0
