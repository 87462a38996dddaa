"""Disaggregated serving workers: the port of lws_tpu/serving/disagg_worker.py,
the processes a DisaggregatedSet's prefill and decode roles run.

  python -m lws_tpu_torch.serving.disagg_worker prefill [--device cuda|cpu]
  python -m lws_tpu_torch.serving.disagg_worker decode  [--device cuda|cpu]

TCP is the transport: the prefill worker serves prompts in and KV bundles
out on its LWS_TPU_KV_PORT; the decode worker discovers prefill's endpoint
from the DS's revision-aware `-prv` service record through the API server
(LWS_TPU_API), pulls bundles over the socket, decodes, and serves results
on its own port. The wire is the JAX package's, so either role may be a
JAX worker. A prompt longer than `LWS_TPU_KV_CHUNK` rows (default 256; 0
turns streaming off) hands off STREAMED: the bundle is offered before
prefill computes, and each chunk's K/V leaves while the next one computes.

Both roles build the SAME model from a shared seed (in production, the same
checkpoint), so prefill's cache is exactly what decode expects. `--device`
plays the role the pod env's JAX_PLATFORMS plays for a JAX worker; it
defaults to the GPU, and without one the worker raises.

Tensor-parallel roles. `LWS_TPU_TP=N` (N >= 1) serves the role on an N-rank
tp mesh, one process per card: the JAX worker is one process driving N
devices, the port's TP is one process per device (parallel/). The worker
process is tp rank 0; it spawns ranks 1..N-1 on this host
(parallel/launch.py, gloo under `--device cpu`, NCCL on the cards its
CUDA_VISIBLE_DEVICES shows, a rendezvous port of its own), and only it owns
the sockets, the KVServer, the endpoint discovery, the deadlines, the dedup
guard, the breakers and the poison guard. The other ranks loop on the
commands rank 0 sends them (prefill this prompt, decode the bundle rank 0
holds, stop): rank 0 decides everything only it can see (an expired
deadline, a replay, an open circuit, a poison payload, a drain) before it
sends a command, so every rank enters the same collectives in the same
order. Prefill gathers the KV heads over tp (tp_gathered in the handoff
record) into the single-device bundle; decode scatters the bundle's heads
from rank 0 onto its mesh (reshard_s). On SIGTERM rank 0 drains, sends the
stop, and reaps the other ranks; a rank whose rank 0 died exits on its own.
N = 1 is a one-rank mesh: every seam of the TP path, no second card.

Telemetry as in the JAX workers: tracing is forced on, and each result
ships its handoff's span subtree (`serve.request`, `serve.prefill`,
`kv.gather` from prefill; `serve.request`, `kv.deserialize`, `kv.reshard`,
`serve.decode_dispatch` from decode), from whose durations the handoff
record is derived; SLO timelines on both legs carry the request's class
from the frame meta; `serving_kv_handoffs_total` and
`serving_kv_handoff_bytes_total` count the handoffs; the fault points
`disagg.prefill.handoff` and `disagg.decode.process` arm from
`LWS_TPU_FAULTS`. With `LWS_TPU_METRICS_PORT` in the env, tp rank 0 of
each role serves the worker telemetry server (runtime/telemetry.py:
/metrics, the journeys at /debug/request/<id>, `POST /debug/faults` to arm
faults live, `POST /debug/drain` to drain as SIGTERM does). Each request's
journey (obs/journey.py) completes with its SLO timeline on each leg, or
with its ending when the leg drops it (an expired deadline) or fails it
(the decode poison guard); a
streamed handoff's chunk timelines annotate it (`chunks_produced` on
prefill, `chunks` on decode).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import faults, metrics, resilience, slo, trace
from lws_tpu_torch.obs import device as devicemod
from lws_tpu_torch.obs import journey as journeymod
from lws_tpu_torch.serving import kv_host_arena
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.pipeline import DecodePipeline

MODEL_SEED = 1234  # the JAX workers' jax.random.key(1234)


def role_tp() -> int:
    """The role's tensor-parallel degree (`LWS_TPU_TP`; 0 or unset: no mesh)."""
    return int(os.environ.get("LWS_TPU_TP", "0") or 0)


def build_model(max_len: int, device: DeviceLike = None, scale: Optional[str] = None):
    """The flagship model with int8 weights from the shared seed, at `scale`
    (default: "full" when LWS_TPU_MODEL=flagship, the llama-3-8B shape, else
    "smoke"). K/V stay unquantized (bf16 at full scale), as in the JAX
    workers. Every rank of a TP role draws the same full model; the engine
    keeps the rank's shard. Returns (cfg, params)."""
    from lws_tpu_torch.models.flagship import flagship_config, init_quantized_params

    device = resolve_device(device)
    if scale is None:
        scale = "full" if os.environ.get("LWS_TPU_MODEL") == "flagship" else "smoke"
    cfg = flagship_config(scale, max_seq_len=max_len)
    params = init_quantized_params(
        cfg, torch.Generator(device=device).manual_seed(MODEL_SEED), device=device)
    return cfg, params


def build_engine(batch: int, max_len: int, device: DeviceLike = None, mesh=None) -> Engine:
    """A dense Engine over build_model's weights (on `mesh`, the rank's shard)."""
    cfg, params = build_model(max_len, device)
    return Engine(cfg, params, batch_size=batch, max_len=max_len, device=params.device,
                  mesh=mesh)


# ---------------------------------------------------------------------------
# The role's tensor-parallel group


def _watch_parent(parent: int) -> None:
    """A rank whose rank 0 is gone exits, whatever collective it waits in:
    no rank outlives its role holding a card."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)


def _follower(rank: int, role: str, device: str, max_len: int, queues: list, parent: int
              ) -> None:
    """Rank `rank` (> 0) of a role's group: start the group from the env
    contract spawn_group set, build the engine's shard, then run rank 0's
    commands until it sends the stop."""
    import torch.distributed as dist

    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env, local_device

    # The stop comes from rank 0, after its drain; a signal to the whole
    # process group must not cut a rank out of a collective.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    _force_tracing()
    faults.arm_from_env()
    want = None if device == "cuda" else device
    info = initialize_from_env(device=want)
    dev = local_device(info, want)
    mesh = build_mesh(MeshSpec(tp=info.num_processes))
    if dev.type == "cuda":
        from lws_tpu_torch.ops import _ext

        _ext.build_on_rank_zero()
    engine = build_engine(batch=1, max_len=max_len, device=dev, mesh=mesh)
    commands = queues[rank - 1]
    while True:
        cmd = commands.get()
        if cmd["op"] == "stop":
            break
        try:
            if cmd["op"] == "prefill" and cmd["chunk"] > 0:
                _prefill_compute(engine, cmd["prompt"], cmd["chunk"])  # gathers per chunk
            elif cmd["op"] == "prefill":
                token, cache, _ = _prefill_compute(engine, cmd["prompt"], 0)
                kt.cache_to_bundle(cache, token, mesh=engine.mesh)  # rank 0 keeps the bytes
            elif cmd["op"] == "decode":
                _decode_bundle(engine, None, cmd["steps"], gamma=cmd["gamma"],
                               ngram=cmd["ngram"], context=cmd["context"])
        except Exception as e:  # noqa: BLE001 — rank 0 failed the same request
            print(f"[{role} rank {rank}] {cmd['op']} failed: {e!r}", flush=True)
    dist.destroy_process_group()


class RoleGroup:
    """A role's tp group as tp rank 0 holds it: the other ranks' processes
    and command queues, the started torch.distributed group and its mesh,
    and this rank's card (`device`)."""

    def __init__(self, role: str, tp: int, device: str, max_len: int) -> None:
        import torch.multiprocessing as mp

        from lws_tpu_torch.parallel import (
            MeshSpec,
            build_mesh,
            initialize_from_env,
            launch,
            local_device,
        )

        self.tp = tp
        self._ctx = None
        self._queues: list = []
        env0: dict = {}
        if tp > 1:
            spawn = mp.get_context("spawn")
            self._queues = [spawn.SimpleQueue() for _ in range(tp - 1)]
            self._ctx, envs = launch.spawn_group(
                _follower, tp, args=(role, device, max_len, self._queues, os.getpid()),
                ranks=range(1, tp))
            env0 = envs[0]
        want = None if device == "cuda" else device
        # The group's own contract, not the pod's: the role's ranks are its
        # children on this host.
        info = initialize_from_env(env=env0, device=want, group_of_one=True)
        self.device = local_device(info, want)
        self.mesh = build_mesh(MeshSpec(tp=tp))
        if self.device.type == "cuda":
            from lws_tpu_torch.ops import _ext

            _ext.build_on_rank_zero()

    def send(self, cmd: dict) -> None:
        """One command to every other rank, in the order rank 0 issues them."""
        for q in self._queues:
            q.put(cmd)

    def stop(self, timeout_s: float = 60.0) -> None:
        """Send the stop, reap every other rank, tear the group down."""
        import torch.distributed as dist

        from lws_tpu_torch.parallel import launch

        self.send({"op": "stop"})
        if self._ctx is not None:
            launch.join(self._ctx, timeout_s=timeout_s)
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The legs


def _decode_bundle(engine: Engine, payload, steps: int, gamma: int = 0, ngram: int = 3,
                   klass: str = "", request_id: str = "", context=None
                   ) -> tuple[np.ndarray, dict, list]:
    """A bundle (monolithic payload bytes, or a finished streamed
    CacheAssembler) -> ([B, steps + 1] tokens, the handoff stats, the span
    records). Without a mesh, a monolithic bundle's rows are copied into a
    cache of DECODE's own max_len, and a streamed one was uploaded chunk by
    chunk as it arrived, so `kv.deserialize` times only take(). On a mesh
    the bundle (a streamed one assembled on the host) is scattered by head
    onto the ranks in `kv.reshard`; rank 0 passes the payload and the other
    ranks None, with `context` (the prompt tokens a stream shipped) as rank
    0 sent it. With gamma > 0 the decode leg runs device-resident
    speculative decoding (Engine.decode_speculative), whose drafting history
    a streamed handoff seeds with the prompt tokens it shipped. The stats
    are the span durations."""
    with devicemod.compile_site("disagg.decode", engine="disagg", shape=f"steps{steps}/g{gamma}",
                                request_id=request_id):
        return _decode_bundle_inner(engine, payload, steps, gamma, ngram, klass, request_id,
                                    context)


def _decode_bundle_inner(engine: Engine, payload, steps: int, gamma: int, ngram: int,
                         klass: str, request_id: str, context):
    if isinstance(payload, kt.PoisonPayload):
        # Streamed content this engine rejected: surface it here, so the
        # worker's poison guard consumes the request with a failed result.
        raise payload.error
    mesh = engine.mesh
    streamed = isinstance(payload, kt.CacheAssembler)
    bundle_bytes = payload.payload_bytes if streamed else len(payload) if payload else 0
    bundle = None
    with trace.span("kv.deserialize", bundle_bytes=bundle_bytes, streamed=streamed,
                    chunks=payload.chunks if streamed else 0) as s_deser:
        if mesh is None and streamed:
            cache, token, pos, context = payload.take()
        elif mesh is None:
            cache, token = kt.bundle_to_cache(payload, max_len=engine.max_len,
                                              device=engine.device)
            pos = cache.pos
        elif streamed:
            bundle, context = payload.bundle(), payload.context()
        else:
            bundle = payload  # parsed inside the reshard, whose refusal every rank shares
    with trace.span("kv.reshard", tp_sharded=mesh is not None) as s_reshard:
        if mesh is not None:
            cache, token = kt.bundle_to_cache(bundle, max_len=engine.max_len,
                                              device=engine.device, mesh=mesh)
            pos = cache.pos
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)  # the span times the scatter itself
    out: dict = {}
    spec_stats: dict = {}
    # engine="disagg" on the span and the pipeline's metrics alike.
    with trace.span("serve.decode_dispatch", engine="disagg", steps=steps) as s_decode:
        if gamma > 0:
            _, _, out["toks"] = engine.decode_speculative(token, cache, steps, gamma=gamma,
                                                          ngram=ngram, pos=pos, context=context,
                                                          engine_label="disagg")
            spec_stats = {"spec_gamma": gamma}
            first = token.cpu().numpy()
        else:
            # Dispatch first, then copy the first token to the host while the
            # decode chunk runs on the device.
            pipe = DecodePipeline(depth=1, engine="disagg")
            with pipe.host_section():
                _, _, tokens = engine.decode_n(token, cache, steps)
            pipe.push(steps, tokens, lambda h: out.__setitem__("toks", h))
            first = token.cpu().numpy()
            pipe.flush()  # blocks: decode_s is the real dispatch time
    # Journey wire leg: a streamed handoff's per-chunk arrival timeline
    # (collected by the stream receiver while the wire was still moving)
    # attaches to this request's journey before the verdict folds.
    if streamed and getattr(payload, "chunk_timeline", None) and request_id:
        journeymod.VAULT.annotate(request_id, chunks=payload.chunk_timeline)
    # The decode leg's SLO timeline: the chunk's mean step gap is the ITL
    # sample; the class rode the bundle meta from the submitting client.
    timeline = slo.request("disagg", klass=klass, request_id=request_id)
    timeline.tokens(steps, s_decode.duration_s)
    timeline.finish()
    stats = {
        "bundle_bytes": bundle_bytes,
        "deserialize_s": _handoff_s(s_deser),
        "reshard_s": _handoff_s(s_reshard),
        "decode_s": _handoff_s(s_decode),
        **({"streamed": True, "chunks": payload.chunks} if streamed else {}),
        **spec_stats,
    }
    spans = [s.to_dict() for s in (s_deser, s_reshard, s_decode)]
    return np.concatenate([first[:, None], out["toks"]], axis=1), stats, spans


def _prefill_compute(engine: Engine, prompt, chunk_tokens: int, emit=None):
    """The prefill leg's compute as every rank runs it: with chunk_tokens >
    0 a chunked prefill whose chunks (their KV heads gathered under a mesh)
    go to `emit` on tp rank 0, else a one-shot prefill. Returns (token,
    cache, the chunked prefill's stats | None)."""
    tokens = np.asarray(prompt).reshape(1, -1)
    if chunk_tokens > 0:
        return engine.prefill_chunked_stream(tokens, chunk_tokens, emit=emit)
    token, cache = engine.prefill(tokens)
    return token, cache, None


def _handoff_s(span) -> float:
    """A span's seconds as the handoff record carries them: the shipped
    span's duration (to_dict's 6 places) to 4 places, so the record reads
    off the spans it ships with exactly (rounding the raw duration straight
    to 4 places can differ from that in the last place)."""
    return round(span.to_dict()["duration_s"], 4)


def _own_pod(client, namespace: str, pod_name: str) -> dict:
    return client.get("Pod", namespace, pod_name)


def _force_tracing() -> None:
    """Workers trace every request whatever the env's sampling: the span
    subtree is the handoff's cost breakdown each result ships."""
    trace.TRACER.enabled = True
    trace.TRACER.sample_rate = 1.0


def _start_telemetry():
    """Serve this worker's /metrics and debug surface when the pod declares
    a telemetry port (LWS_TPU_METRICS_PORT), the surface the control
    plane's fleet scraper merges into /metrics/fleet. A declared port that
    cannot be bound raises."""
    from lws_tpu_torch.runtime.telemetry import start_from_env

    server = start_from_env()
    if server is not None:
        print(f"[{os.environ.get('POD_NAME', '?')}] telemetry on :{server.port}", flush=True)
    return server


def _serve_prefix_tier(server: kt.KVServer) -> None:
    """Join the cross-instance prefix tier: advertise this worker's KV wire
    port for siblings' `fetch_prefix` calls (kv_host_arena.debug_prefixes)
    and serve arena-resident spilled blocks over it."""
    kv_host_arena.register_fetch_port(server.port)
    server.serve_prefixes(kv_host_arena.get_spilled)


def kv_chunk_tokens() -> int:
    """The streamed handoff's chunk size (`LWS_TPU_KV_CHUNK`, rows per stream
    chunk; default 256); 0 selects the monolithic single-shot path."""
    return int(os.environ.get("LWS_TPU_KV_CHUNK", "256") or 0)


def use_streaming(prompt_len: int, chunk_tokens: int, max_len: Optional[int] = None) -> bool:
    """Stream only a prompt of several chunks (a one-chunk stream is the
    single-shot transfer with extra frames) whose chunk-padded length fits
    `max_len` (chunked prefill pads to whole chunks; the single-shot path
    serves a prompt whose padding would not fit)."""
    if chunk_tokens <= 0 or prompt_len <= chunk_tokens:
        return False
    if max_len is not None and prompt_len + ((-prompt_len) % chunk_tokens) > max_len:
        return False
    return True


def _bundle_meta(meta: dict, req_id: str, deadline, trace_ctx, **extra) -> dict:
    """A bundle's frame meta: the request id, the prefill request span's
    context (decode's subtree grafts under it), and what rode in with the
    prompt for the decode side (a workload class, the remaining deadline)."""
    out = {"id": req_id, "trace": trace_ctx, **extra}
    if meta.get("klass"):
        out["klass"] = str(meta["klass"])
    if deadline is not None:
        out["deadline_s"] = deadline.to_wire()
    return out


def _prefill_streamed(engine: Engine, server: kt.KVServer, meta: dict, req_id: str, prompt,
                      chunk_tokens: int, deadline, group: Optional[RoleGroup] = None) -> None:
    """One STREAMED handoff: offer the KVStream first (a decode puller
    attaches while chunks are still produced), then run the chunked prefill
    whose emit callback lands each position range in the stream, its K/V
    copied to the host by kv_transport.host_array (under a mesh, after the
    ranks' head gather). The END frame carries the first token and pos, the
    handoff record and the span subtree. A producer failure fails the
    stream (the server tells the puller and drops it)."""
    # Death mid-handoff, streamed placement: before the offer, so an armed
    # exit kills the request's only copy (the router's resubmit recovers).
    faults.fire("disagg.prefill.handoff")
    stream = kt.KVStream(chunk_tokens)
    s_req = trace.span("serve.request", parent=meta.get("trace"), role="prefill",
                       request_id=req_id)
    klass = str(meta.get("klass") or "")
    server.offer_stream(_bundle_meta(meta, req_id, deadline, s_req.context), stream)
    try:
        if group is not None:
            group.send({"op": "prefill", "prompt": np.asarray(prompt), "chunk": chunk_tokens})
        with s_req:
            timeline = slo.request("disagg", klass=klass, request_id=req_id)
            wait = float(meta.get("queue_wait_s", 0.0))
            timeline.queue_wait(wait)
            # kv.gather parents serve.prefill: the two overlap by design, so
            # the gather span covers the streaming window and carries the
            # chunks' summed gather time.
            with trace.span("kv.gather", streamed=True,
                            tp_gathered=engine.mesh is not None) as s_gather:
                with trace.span("serve.prefill", chunked=True,
                                prompt_len=int(np.asarray(prompt).size)) as s_prefill:
                    token, cache, pstats = _prefill_compute(engine, prompt, chunk_tokens,
                                                            emit=stream.put_chunk)
                    first = token.cpu().numpy()  # the fence: prefill_s is the dispatch time
                s_gather.set(pos=int(cache.pos), bundle_bytes=stream.payload_bytes,
                             chunks=pstats["chunks"], gather_s=round(pstats["gather_s"], 4))
            # Journey wire leg, produce side: when each chunk left prefill
            # compute (the arrival twin lands on the decode journey).
            journeymod.VAULT.annotate(req_id, chunks_produced=list(stream.chunk_timeline))
            timeline.first_token(wait + s_prefill.duration_s)
            timeline.finish()
    except Exception:
        stream.fail()  # wake the puller with a terminal verdict
        raise
    handoff = {
        "pos": int(cache.pos),
        "bundle_bytes": stream.payload_bytes,
        "prefill_s": _handoff_s(s_prefill),
        "gather_s": round(pstats["gather_s"], 4),
        "tp_gathered": engine.mesh is not None,
        "streamed": True,
        "chunks": pstats["chunks"],
    }
    metrics.inc("serving_kv_handoffs_total")
    metrics.inc("serving_kv_handoff_bytes_total", value=stream.payload_bytes)
    stream.finish({"handoff": handoff,
                   "spans": [s.to_dict() for s in (s_req, s_prefill, s_gather)]},
                  {"token": first, "pos": np.asarray(int(cache.pos), np.int32)})
    print(f"[prefill] HANDOFF {req_id} {json.dumps(handoff)}", flush=True)


def _prefill_monolithic(engine: Engine, server: kt.KVServer, meta: dict, req_id: str,
                        prompt, deadline, group: Optional[RoleGroup] = None) -> None:
    """One single-shot handoff: prefill, gather the pos-truncated cache into
    one bundle (under a mesh, the ranks' KV heads), offer it with the
    handoff record and the span subtree."""
    if group is not None:
        group.send({"op": "prefill", "prompt": np.asarray(prompt), "chunk": 0})
    klass = str(meta.get("klass") or "")
    with trace.span("serve.request", parent=meta.get("trace"), role="prefill",
                    request_id=req_id) as s_req:
        # The KVServer stamped the prompt at enqueue: the queue wait is the
        # real socket-to-worker wait, and TTFT covers it and the prefill.
        timeline = slo.request("disagg", klass=klass, request_id=req_id)
        wait = float(meta.get("queue_wait_s", 0.0))
        timeline.queue_wait(wait)
        with trace.span("serve.prefill", chunked=False,
                        prompt_len=int(np.asarray(prompt).size)) as s_prefill:
            token, cache, _ = _prefill_compute(engine, prompt, 0)
            token.cpu()  # the fence: prefill_s is the real dispatch time
        timeline.first_token(wait + s_prefill.duration_s)
        with trace.span("kv.gather", tp_gathered=engine.mesh is not None) as s_gather:
            bundle = kt.cache_to_bundle(cache, token, mesh=engine.mesh)
            s_gather.set(pos=int(cache.pos), bundle_bytes=len(bundle))
        # finish() completes the journey: it runs after kv.gather closes, or
        # the gather leg would never join the completed journey.
        timeline.finish()
    handoff = {
        "pos": int(cache.pos),
        "bundle_bytes": len(bundle),
        "prefill_s": _handoff_s(s_prefill),
        "gather_s": _handoff_s(s_gather),
        "tp_gathered": engine.mesh is not None,
    }
    metrics.inc("serving_kv_handoffs_total")
    metrics.inc("serving_kv_handoff_bytes_total", value=len(bundle))
    # Death mid-handoff: after the prefill, before the offer (the request's
    # only copy dies with the process; the router's resubmit recovers).
    faults.fire("disagg.prefill.handoff")
    server.offer_bundle(_bundle_meta(meta, req_id, deadline, s_req.context, handoff=handoff,
                                     spans=[s.to_dict() for s in (s_req, s_prefill, s_gather)]),
                        bundle)
    print(f"[prefill] HANDOFF {req_id} {json.dumps(handoff)}", flush=True)


def run_prefill_tcp(once: bool, max_len: int, device: DeviceLike = None,
                    group: Optional[RoleGroup] = None) -> int:
    """Serve prompts in and KV bundles out on LWS_TPU_KV_PORT. With `once`,
    exit after the first bundle has been pulled AND acked. SIGTERM (or POST
    /debug/drain on the telemetry port) drains: stop admitting prompts,
    finish the handoff in flight, exit clean."""
    _start_telemetry()
    engine = build_engine(batch=1, max_len=max_len,
                          device=group.device if group is not None else device,
                          mesh=group.mesh if group is not None else None)
    server = kt.KVServer(port=int(os.environ.get("LWS_TPU_KV_PORT", "0")))
    _serve_prefix_tier(server)
    chunk_tokens = kv_chunk_tokens()
    tp = f", tp={group.tp}" if group is not None else ""
    print(f"[prefill {os.environ.get('POD_NAME', '?')}] serving KV on :{server.port}"
          f" (kv_chunk={chunk_tokens}, device={engine.device}{tp})", flush=True)
    while True:
        if resilience.DRAIN.draining:
            print(f"[prefill] DRAINED ({resilience.DRAIN.reason}): "
                  f"{server.delivery_counts()[0]} bundles delivered; exiting clean", flush=True)
            return 0
        if once and server.delivery_counts()[0] >= 1:
            return 0
        item = server.next_prompt(timeout=0.5)
        if item is not None:
            handle_prompt(engine, server, *item, chunk_tokens, group)


def handle_prompt(engine: Engine, server: kt.KVServer, meta: dict, payload, chunk_tokens: int,
                  group: Optional[RoleGroup] = None) -> None:
    """The prefill role's work for one queued prompt: drop it if its
    deadline expired in the queue, else hand it off, streamed or
    monolithic."""
    req_id = meta["id"]
    deadline = resilience.Deadline.from_wire(meta.get("deadline_s"))
    if deadline is not None and deadline.expired():
        resilience.expire("prefill.admit", request_id=req_id)
        # The drop is the request's ending here: its journey completes
        # deadline-expired, so the vault keeps the story.
        journeymod.VAULT.complete(req_id, trace=meta.get("trace"), engine="disagg",
                                  klass=str(meta.get("klass") or ""), outcome="deadline_expired")
        print(f"[prefill] DROPPED {req_id}: deadline expired in queue", flush=True)
        return
    prompt = kt.bytes_to_arrays(payload)["prompt"]
    if use_streaming(int(prompt.size), chunk_tokens, engine.max_len):
        _prefill_streamed(engine, server, meta, req_id, prompt, chunk_tokens, deadline, group)
    else:
        _prefill_monolithic(engine, server, meta, req_id, prompt, deadline, group)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def run_decode_tcp(steps: int, once: bool, max_len: int, gamma: int = 0, ngram: int = 3,
                   device: DeviceLike = None, group: Optional[RoleGroup] = None) -> int:
    """Discover prefill's endpoint from the DS -prv service record, pull KV
    bundles over TCP, decode, serve results. The pull is acked only AFTER
    the result is posted (a crash mid-decode re-queues the bundle on
    prefill); a replayed id is acked without decoding again. With `once`,
    exit after the first result has been delivered. SIGTERM (or POST
    /debug/drain) drains between pulls."""
    from lws_tpu_torch.client import RemoteClient

    _start_telemetry()
    engine = build_engine(batch=1, max_len=max_len,
                          device=group.device if group is not None else device,
                          mesh=group.mesh if group is not None else None)
    server = kt.KVServer(port=int(os.environ.get("LWS_TPU_KV_PORT", "0")))
    _serve_prefix_tier(server)
    process = decode_processor(engine, server, steps, gamma, ngram, group)
    breakers: dict[str, resilience.CircuitBreaker] = {}
    me = os.environ.get("POD_NAME", str(os.getpid()))
    namespace = os.environ.get("POD_NAMESPACE", "default")
    client = RemoteClient(os.environ["LWS_TPU_API"])
    labels = _own_pod(client, namespace, me)["metadata"]["labels"]
    ds_name = labels[kt.DS_NAME_LABEL_KEY]
    # Pin the pairing to OUR revision and slice: across a rollout both
    # revisions' -prv services coexist (another revision: other weights).
    revision = labels.get(kt.DS_REVISION_LABEL_KEY)
    slice_idx = labels.get(kt.DS_SLICE_LABEL_KEY)
    tp = f", tp={group.tp}" if group is not None else ""
    print(f"[decode {me}] serving results on :{server.port} (device={engine.device}{tp}); "
          f"discovering prefill of DS {ds_name!r} rev={revision} slice={slice_idx}", flush=True)

    endpoint = None
    breaker = None
    while True:
        if resilience.DRAIN.draining:
            print(f"[decode] DRAINED ({resilience.DRAIN.reason}): "
                  f"{server.delivery_counts()[1]} results delivered; unacked bundles stay "
                  "queued on prefill; exiting clean", flush=True)
            return 0
        if once and server.delivery_counts()[1] >= 1:
            return 0
        if endpoint is None:
            # The -prv service exists only once the revision is ready on all roles.
            endpoint = kt.discover_role_endpoint(client, namespace, ds_name, "prefill",
                                                 revision=revision, slice_idx=slice_idx)
            if endpoint is None:
                time.sleep(0.5)
                continue
            print(f"[decode] prefill endpoint via -prv service: {endpoint}", flush=True)
            # One breaker per endpoint, kept across rediscoveries and bounded
            # (every prefill roll mints a fresh ip:port; the evicted one's
            # gauge retires).
            name = f"prefill@{endpoint[0]}:{endpoint[1]}"
            if name not in breakers:
                while len(breakers) >= 8:
                    breakers.pop(next(iter(breakers))).retire()
                breakers[name] = resilience.CircuitBreaker(
                    name, failure_threshold=int(_env_float("LWS_TPU_BREAKER_THRESHOLD", 5)),
                    reset_timeout_s=_env_float("LWS_TPU_BREAKER_RESET_S", 5.0))
            breaker = breakers[name]
        if not breaker.allow():
            time.sleep(0.1)  # open circuit: fail fast instead of re-dialing
            continue
        try:
            resilience.call(
                lambda: kt.pull_bundle(endpoint, timeout=1.0, process=process, ack_timeout=600.0,
                                       receiver_factory=receiver_factory(engine)),
                site="kv.pull_bundle",
                policy=resilience.RetryPolicy(max_attempts=2, base_s=0.05, cap_s=0.25),
            )
            breaker.record_success()
        except OSError:
            breaker.record_failure()
            endpoint = None  # the peer rolled or moved: rediscover


def receiver_factory(engine: Engine):
    """pull_bundle's stream receiver for `engine`: a CacheAssembler on the
    engine's device without a mesh (each chunk uploaded as it arrives), on
    the host under one (the reshard scatters it)."""
    device = engine.device if engine.mesh is None else False
    return lambda begin_meta: kt.CacheAssembler(max_len=engine.max_len, device=device)


def decode_processor(engine: Engine, server: kt.KVServer, steps: int, gamma: int = 0,
                     ngram: int = 3, group: Optional[RoleGroup] = None):
    """The decode role's `process(meta, payload)` for pull_bundle: the
    chaos hook, the replay dedup (a bounded seen-id guard: ack loss and
    redelivery replay bundles), the deadline, then the decode and its
    result. A failure the chaos hook raises leaves the bundle unacked (it
    is redelivered); a bundle this engine cannot process ends the request
    with a failed result and an errored journey. Under a group, the other
    ranks are told to decode only once every check only rank 0 can make
    has passed."""
    seen = resilience.SeenIds(capacity=1024, site="decode")

    def fail(meta, error: str, outcome: str) -> None:
        """End the request here: its journey completes with `outcome`, the
        client gets a failed result, and a redelivery of the id is acked."""
        journeymod.VAULT.complete(meta["id"], trace=meta.get("trace"), engine="disagg",
                                  klass=str(meta.get("klass") or ""), outcome=outcome,
                                  error=error if outcome == "errored" else None)
        server.post_result(meta["id"], {"id": meta["id"], "failed": error[:300]}, b"")
        seen.record(meta["id"])

    def process(meta, payload):
        # Decode fails mid-processing: the raise (or exit) leaves the
        # bundle unacked, it re-queues on prefill, and the pull's retry (or
        # a successor) redelivers it.
        faults.fire("disagg.decode.process")
        if seen.contains(meta["id"]):
            # A replayed delivery (the ack was lost): the result was posted.
            print(f"[decode] REPLAY {meta['id']}: already decoded, acking without re-decode",
                  flush=True)
            return
        deadline = resilience.Deadline.from_wire(meta.get("deadline_s"))
        if deadline is not None and deadline.expired():
            resilience.expire("decode.admit", request_id=meta["id"])
            fail(meta, "deadline exceeded before decode", "deadline_expired")
            return
        klass = str(meta.get("klass") or "")
        if group is not None and not isinstance(payload, kt.PoisonPayload):
            # Every check only rank 0 can make is behind us: the ranks now
            # enter the reshard and the decode together.
            context = payload.context() if isinstance(payload, kt.CacheAssembler) else None
            group.send({"op": "decode", "steps": steps, "gamma": gamma, "ngram": ngram,
                        "context": context})
        # Decode's subtree parents under the prefill request span (the
        # bundle meta's trace context): one tree, client -> prefill -> decode.
        s_req = trace.span("serve.request", parent=meta.get("trace"), role="decode",
                           request_id=meta["id"])
        try:
            with s_req:
                full, dstats, dspans = _decode_bundle(engine, payload, steps, gamma=gamma,
                                                      ngram=ngram, klass=klass,
                                                      request_id=meta["id"])
        except Exception as e:  # noqa: BLE001
            # Poison guard: a bundle this engine cannot process (e.g. more
            # rows than max_len) is consumed with a failed result; an
            # un-acked crash would re-queue it forever.
            print(f"[decode] FAILED {meta['id']}: {e!r}", flush=True)
            fail(meta, repr(e), "errored")
            return
        handoff = {**meta.get("handoff", {}), **dstats}
        if "wire_s" in meta:  # this side's clock: the reply's first byte to its last
            handoff["wire_s"] = round(meta["wire_s"], 4)
        spans_out = list(meta.get("spans", [])) + dspans + [s_req.to_dict()]
        server.post_result(meta["id"], {"id": meta["id"], "handoff": handoff, "spans": spans_out},
                           kt.arrays_to_bytes(tokens=full))
        seen.record(meta["id"])  # only now is the id complete
        print(f"[decode] HANDOFF {meta['id']} {json.dumps(handoff)}", flush=True)
        print(f"[decode] finished {meta['id']}: {full[0][:8]}...", flush=True)

    return process


def main(argv=None) -> int:
    # SIGTERM is the kubelet's stop signal: drain instead of dying mid-request.
    resilience.DRAIN.install_signal_handler()
    faults.arm_from_env()
    _force_tracing()
    parser = argparse.ArgumentParser()
    parser.add_argument("role", choices=["prefill", "decode"])
    parser.add_argument("--transport", choices=["tcp"], default="tcp")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--max-len", type=int, default=32)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--gamma", type=int,
                        default=int(os.environ.get("LWS_TPU_SPEC_GAMMA", "0") or 0))
    parser.add_argument("--ngram", type=int,
                        default=int(os.environ.get("LWS_TPU_SPEC_NGRAM", "3") or 3))
    parser.add_argument("--device", default="cuda",
                        help="the engine's device (default cuda; raises without a GPU)")
    args = parser.parse_args(argv)
    tp = role_tp()
    group = RoleGroup(args.role, tp, args.device, args.max_len) if tp >= 1 else None
    try:
        if args.role == "prefill":
            return run_prefill_tcp(args.once, args.max_len, device=args.device, group=group)
        return run_decode_tcp(args.steps, args.once, args.max_len, gamma=args.gamma,
                              ngram=args.ngram, device=args.device, group=group)
    finally:
        from lws_tpu_torch.ops import launch_counts

        print(f"[{args.role}] kernel launches {json.dumps(launch_counts())}", flush=True)
        if group is not None:
            group.stop()
            print(f"[{args.role}] stopped {tp - 1} other rank(s)", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
