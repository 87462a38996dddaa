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

Left out: tensor-parallel workers (`LWS_TPU_TP > 1` raises; the multi-GPU
slice), and the telemetry the JAX workers carry (trace spans ship as [],
journeys, SLO timelines, the metrics server, fault points, and the fleet's
prefix advertisement).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import resilience
from lws_tpu_torch.serving import kv_host_arena
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.pipeline import DecodePipeline

MODEL_SEED = 1234  # the JAX workers' jax.random.key(1234)


def build_model(max_len: int, device: DeviceLike = None, scale: Optional[str] = None):
    """The flagship model with int8 weights from the shared seed, at `scale`
    (default: "full" when LWS_TPU_MODEL=flagship, the llama-3-8B shape, else
    "smoke"). K/V stay unquantized (bf16 at full scale), as in the JAX
    workers. Returns (cfg, params)."""
    from lws_tpu_torch.models.flagship import flagship_config, init_quantized_params

    tp = int(os.environ.get("LWS_TPU_TP", "0") or 0)
    if tp > 1:
        raise NotImplementedError(
            f"LWS_TPU_TP={tp}: tensor-parallel workers come with the port's multi-GPU slice")
    device = resolve_device(device)
    if scale is None:
        scale = "full" if os.environ.get("LWS_TPU_MODEL") == "flagship" else "smoke"
    cfg = flagship_config(scale, max_seq_len=max_len)
    params = init_quantized_params(
        cfg, torch.Generator(device=device).manual_seed(MODEL_SEED), device=device)
    return cfg, params


def build_engine(batch: int, max_len: int, device: DeviceLike = None) -> Engine:
    """A dense Engine over build_model's weights."""
    cfg, params = build_model(max_len, device)
    return Engine(cfg, params, batch_size=batch, max_len=max_len, device=params.device)


def _decode_bundle(engine: Engine, payload, steps: int, gamma: int = 0,
                   ngram: int = 3) -> tuple[np.ndarray, dict, list]:
    """A bundle (monolithic payload bytes, or a finished streamed
    CacheAssembler) -> ([B, steps + 1] tokens, the handoff stats, spans).
    A monolithic bundle's rows are copied into a cache of DECODE's own
    max_len; a streamed one was uploaded chunk by chunk as it arrived, so
    `deserialize_s` times only take(). With gamma > 0 the decode leg runs
    device-resident speculative decoding (Engine.decode_speculative), whose
    drafting history a streamed handoff seeds with the prompt tokens it
    shipped. The spans ship as [] (the JAX worker's trace spans come with
    the telemetry slice)."""
    if isinstance(payload, kt.PoisonPayload):
        # Streamed content this engine rejected: surface it here, so the
        # worker's poison guard consumes the request with a failed result.
        raise payload.error
    streamed = isinstance(payload, kt.CacheAssembler)
    bundle_bytes = payload.payload_bytes if streamed else len(payload)
    context = None
    t0 = time.perf_counter()
    if streamed:
        cache, token, pos, context = payload.take()
    else:
        cache, token = kt.bundle_to_cache(payload, max_len=engine.max_len, device=engine.device)
        pos = cache.pos
    deserialize_s = time.perf_counter() - t0
    out: dict = {}
    spec_stats: dict = {}
    t0 = time.perf_counter()
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
    decode_s = time.perf_counter() - t0
    stats = {
        "bundle_bytes": bundle_bytes,
        "deserialize_s": round(deserialize_s, 4),
        "reshard_s": 0.0,  # no mesh: the decode side keeps one device
        "decode_s": round(decode_s, 4),
        **({"streamed": True, "chunks": payload.chunks} if streamed else {}),
        **spec_stats,
    }
    return np.concatenate([first[:, None], out["toks"]], axis=1), stats, []


def _own_pod(client, namespace: str, pod_name: str) -> dict:
    return client.get("Pod", namespace, pod_name)


def _serve_prefix_tier(server: kt.KVServer) -> None:
    """Join the cross-instance prefix tier: serve arena-resident spilled
    blocks over this worker's KV wire for siblings' `fetch_prefix` calls."""
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


def _bundle_meta(meta: dict, req_id: str, deadline, **extra) -> dict:
    """A bundle's frame meta: the request id and what rode in with the
    prompt for the decode side (a trace context, a workload class, the
    remaining deadline)."""
    out = {"id": req_id, **extra}
    if meta.get("trace"):
        out["trace"] = meta["trace"]
    if meta.get("klass"):
        out["klass"] = str(meta["klass"])
    if deadline is not None:
        out["deadline_s"] = deadline.to_wire()
    return out


def _prefill_streamed(engine: Engine, server: kt.KVServer, meta: dict, req_id: str, prompt,
                      chunk_tokens: int, deadline) -> None:
    """One STREAMED handoff: offer the KVStream first (a decode puller
    attaches while chunks are still produced), then run the chunked prefill
    whose emit callback lands each position range in the stream, its K/V
    copied to the host by kv_transport.host_array. The END frame carries the
    first token and pos, and the handoff record. A producer failure fails
    the stream (the server tells the puller and drops it)."""
    stream = kt.KVStream(chunk_tokens)
    server.offer_stream(_bundle_meta(meta, req_id, deadline), stream)
    try:
        t0 = time.perf_counter()
        token, cache, pstats = engine.prefill_chunked_stream(
            np.asarray(prompt).reshape(1, -1), chunk_tokens, emit=stream.put_chunk)
        first = token.cpu().numpy()  # the fence: prefill_s is the real dispatch time
        prefill_s = time.perf_counter() - t0
    except Exception:
        stream.fail()  # wake the puller with a terminal verdict
        raise
    handoff = {
        "pos": int(cache.pos),
        "bundle_bytes": stream.payload_bytes,
        "prefill_s": round(prefill_s, 4),
        "gather_s": round(pstats["gather_s"], 4),
        "tp_gathered": False,
        "streamed": True,
        "chunks": pstats["chunks"],
    }
    stream.finish({"handoff": handoff, "spans": []},
                  {"token": first, "pos": np.asarray(int(cache.pos), np.int32)})
    print(f"[prefill] HANDOFF {req_id} {json.dumps(handoff)}", flush=True)


def _prefill_monolithic(engine: Engine, server: kt.KVServer, meta: dict, req_id: str,
                        prompt, deadline) -> None:
    """One single-shot handoff: prefill, gather the pos-truncated cache into
    one bundle, offer it with the handoff record."""
    t0 = time.perf_counter()
    token, cache = engine.prefill(np.asarray(prompt).reshape(1, -1))
    token.cpu()  # the fence: prefill_s is the real dispatch time
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = kt.cache_to_bundle(cache, token)
    gather_s = time.perf_counter() - t0
    handoff = {
        "pos": int(cache.pos),
        "bundle_bytes": len(bundle),
        "prefill_s": round(prefill_s, 4),
        "gather_s": round(gather_s, 4),
        "tp_gathered": False,
    }
    server.offer_bundle(_bundle_meta(meta, req_id, deadline, handoff=handoff, spans=[]), bundle)
    print(f"[prefill] HANDOFF {req_id} {json.dumps(handoff)}", flush=True)


def run_prefill_tcp(once: bool, max_len: int, device: DeviceLike = None) -> int:
    """Serve prompts in and KV bundles out on LWS_TPU_KV_PORT. With `once`,
    exit after the first bundle has been pulled AND acked. SIGTERM drains:
    stop admitting prompts, finish the handoff in flight, exit clean."""
    engine = build_engine(batch=1, max_len=max_len, device=device)
    server = kt.KVServer(port=int(os.environ.get("LWS_TPU_KV_PORT", "0")))
    _serve_prefix_tier(server)
    chunk_tokens = kv_chunk_tokens()
    print(f"[prefill {os.environ.get('POD_NAME', '?')}] serving KV on :{server.port}"
          f" (kv_chunk={chunk_tokens}, device={engine.device})", flush=True)
    while True:
        if resilience.DRAIN.draining:
            print(f"[prefill] DRAINED ({resilience.DRAIN.reason}): "
                  f"{server.delivery_counts()[0]} bundles delivered; exiting clean", flush=True)
            return 0
        if once and server.delivery_counts()[0] >= 1:
            return 0
        item = server.next_prompt(timeout=0.5)
        if item is None:
            continue
        meta, payload = item
        req_id = meta["id"]
        # An already-expired prompt is dropped, not prefilled.
        deadline = resilience.Deadline.from_wire(meta.get("deadline_s"))
        if deadline is not None and deadline.expired():
            print(f"[prefill] DROPPED {req_id}: deadline expired in queue", flush=True)
            continue
        prompt = kt.bytes_to_arrays(payload)["prompt"]
        if use_streaming(int(prompt.size), chunk_tokens, engine.max_len):
            _prefill_streamed(engine, server, meta, req_id, prompt, chunk_tokens, deadline)
        else:
            _prefill_monolithic(engine, server, meta, req_id, prompt, deadline)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def run_decode_tcp(steps: int, once: bool, max_len: int, gamma: int = 0, ngram: int = 3,
                   device: DeviceLike = None) -> int:
    """Discover prefill's endpoint from the DS -prv service record, pull KV
    bundles over TCP, decode, serve results. The pull is acked only AFTER
    the result is posted (a crash mid-decode re-queues the bundle on
    prefill); a replayed id is acked without decoding again. With `once`,
    exit after the first result has been delivered. SIGTERM drains between
    pulls."""
    from lws_tpu_torch.client import RemoteClient

    engine = build_engine(batch=1, max_len=max_len, device=device)
    server = kt.KVServer(port=int(os.environ.get("LWS_TPU_KV_PORT", "0")))
    _serve_prefix_tier(server)
    seen = resilience.SeenIds(capacity=1024)
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
    print(f"[decode {me}] serving results on :{server.port} (device={engine.device}); "
          f"discovering prefill of DS {ds_name!r} rev={revision} slice={slice_idx}", flush=True)

    def process(meta, payload):
        if seen.contains(meta["id"]):
            # A replayed delivery (the ack was lost): the result was posted.
            print(f"[decode] REPLAY {meta['id']}: already decoded, acking without re-decode",
                  flush=True)
            return
        deadline = resilience.Deadline.from_wire(meta.get("deadline_s"))
        if deadline is not None and deadline.expired():
            server.post_result(meta["id"], {"id": meta["id"],
                                            "failed": "deadline exceeded before decode"}, b"")
            seen.record(meta["id"])
            return
        try:
            full, dstats, dspans = _decode_bundle(engine, payload, steps, gamma=gamma,
                                                  ngram=ngram)
        except Exception as e:  # noqa: BLE001
            # Poison guard: a bundle this engine cannot process (e.g. more
            # rows than max_len) is consumed with a failed result; an
            # un-acked crash would re-queue it forever.
            print(f"[decode] FAILED {meta['id']}: {e!r}", flush=True)
            server.post_result(meta["id"], {"id": meta["id"], "failed": repr(e)[:300]}, b"")
            seen.record(meta["id"])
            return
        handoff = {**meta.get("handoff", {}), **dstats}
        spans_out = list(meta.get("spans", [])) + dspans
        server.post_result(meta["id"], {"id": meta["id"], "handoff": handoff, "spans": spans_out},
                           kt.arrays_to_bytes(tokens=full))
        seen.record(meta["id"])  # only now is the id complete
        print(f"[decode] HANDOFF {meta['id']} {json.dumps(handoff)}", flush=True)
        print(f"[decode] finished {meta['id']}: {full[0][:8]}...", flush=True)

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
            # (every prefill roll mints a fresh ip:port).
            name = f"prefill@{endpoint[0]}:{endpoint[1]}"
            if name not in breakers:
                while len(breakers) >= 8:
                    breakers.pop(next(iter(breakers)))
                breakers[name] = resilience.CircuitBreaker(
                    name, failure_threshold=int(_env_float("LWS_TPU_BREAKER_THRESHOLD", 5)),
                    reset_timeout_s=_env_float("LWS_TPU_BREAKER_RESET_S", 5.0))
            breaker = breakers[name]
        if not breaker.allow():
            time.sleep(0.1)  # open circuit: fail fast instead of re-dialing
            continue
        try:
            # Streamed replies assemble through a CacheAssembler on the
            # engine's device: each chunk is uploaded as it arrives.
            resilience.call(
                lambda: kt.pull_bundle(
                    endpoint, timeout=1.0, process=process, ack_timeout=600.0,
                    receiver_factory=lambda m: kt.CacheAssembler(max_len=engine.max_len,
                                                                 device=engine.device)),
                site="kv.pull_bundle",
                policy=resilience.RetryPolicy(max_attempts=2, base_s=0.05, cap_s=0.25),
            )
            breaker.record_success()
        except OSError:
            breaker.record_failure()
            endpoint = None  # the peer rolled or moved: rediscover


def main(argv=None) -> int:
    resilience.DRAIN.install_signal_handler()
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
    if args.role == "prefill":
        return run_prefill_tcp(args.once, args.max_len, device=args.device)
    return run_decode_tcp(args.steps, args.once, args.max_len, gamma=args.gamma,
                          ngram=args.ngram, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
