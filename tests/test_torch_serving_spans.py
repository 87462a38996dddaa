"""The spans and sections inside the port's serving hot path, on the CPU,
with a tiny dense and a tiny MoE model: the span trees of `submit` and of
`step_n`, each child inside its parent on the trace's clock (a span's
interval is [start_unix, start_unix + duration_s]), stamps taken inside
the engine's calls falling inside the spans that hold them, the model
step's host seconds by section (core/trace.py `section`) on the spans they
belong to, the ring's flushes by cause, and the no-op fast path: with the
tracer off, or no live span, `span()` and `section()` return the shared
NOOP and write nothing."""

import time

import numpy as np
import pytest
import torch

from lws_tpu_torch.core import trace
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models import quant
from lws_tpu_torch.serving import paged_engine
from lws_tpu_torch.serving.paged_engine import PORT_SPANS, PagedBatchEngine

# Rounding of the records (6 decimals) and the gap between a span's
# time.time() and perf_counter() reads.
EPS = 2e-5
N_LAYERS = 2
TOP = ("attn", "ffn", "moe_route", "moe_dispatch", "moe_experts", "moe_combine", "lm_head",
       "sample")  # the sections no other section encloses (dequant lies inside them)


def tiny(moe: bool):
    cfg = tl.LlamaConfig(vocab_size=64, d_model=32, n_layers=N_LAYERS, n_heads=4, n_kv_heads=2,
                         d_ff=64, max_seq_len=128, dtype=torch.float32,
                         param_dtype=torch.float32, remat=False,
                         n_experts=4 if moe else 0, top_k=2)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module", params=["dense", "moe"])
def model(request):
    return request.param, *tiny(request.param == "moe")


@pytest.fixture
def tracer(monkeypatch):
    t = trace.Tracer(ring=1 << 16, enabled=True, sample_rate=1.0)
    monkeypatch.setattr(trace, "TRACER", t)
    return t


def engine(model, **kw):
    _, cfg, params = model
    kw.setdefault("pipeline_depth", 2)
    return PagedBatchEngine(cfg, params, slots=kw.pop("slots", 2), max_len=64, block_size=8,
                            prefix_cache=True, device="cpu", **kw)


def prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 63, size=n).astype(np.int32)


def tree(spans):
    """{span_id: record}, {parent_id: [children in start order]}."""
    by_id = {s["span_id"]: s for s in spans}
    kids = {}
    for s in sorted(spans, key=lambda s: s["start_unix"]):
        kids.setdefault(s["parent_id"], []).append(s)
    return by_id, kids


def interval(s):
    return s["start_unix"], s["start_unix"] + s["duration_s"]


def test_submit_opens_the_admission_tree(model, tracer):
    eng = engine(model)
    assert eng.submit(prompt(20), 4) is not None
    spans = tracer.spans()
    _, kids = tree(spans)
    (root,) = kids[None]
    assert root["name"] == "serve.admission" and root["attrs"] == {"admitted": True}
    assert [c["name"] for c in kids[root["span_id"]]] == [
        "serve.prefix_walk", "serve.prefill", "serve.insert", "serve.first_token"]
    walk, _, _, first = kids[root["span_id"]]
    assert walk["attrs"] == {"hit_blocks": 0, "blocks": 2}  # (20 - 1) // 8 shareable blocks
    assert first["attrs"]["device_wait_s"] <= first["duration_s"] + EPS
    assert {s["name"] for s in spans} - {"serve.admission"} <= set(PORT_SPANS) | {"serve.prefill"}


def test_a_prefix_hit_walks_and_counts_its_blocks(model, tracer):
    eng = engine(model)
    p = prompt(20)
    eng.submit(p, 2)
    eng.run_until_drained()
    tracer.clear()
    eng.submit(p, 2)
    (walk,) = [s for s in tracer.spans() if s["name"] == "serve.prefix_walk"]
    assert walk["attrs"] == {"hit_blocks": 2, "blocks": 2}


def test_step_n_opens_the_dispatch_tree(model, tracer):
    eng = engine(model)
    eng.submit(prompt(12), 30)
    tracer.clear()
    for _ in range(3):  # the third push consumes the first chunk: depth 2
        assert eng.step_n(4) == 4
    spans = tracer.spans()
    by_id, kids = tree(spans)
    roots = kids[None]
    assert [r["name"] for r in roots] == ["serve.decode_dispatch"] * 3
    for r in roots[:2]:
        assert [c["name"] for c in kids[r["span_id"]]] == ["serve.decode_launch"]
    assert [c["name"] for c in kids[roots[2]["span_id"]]] == [
        "serve.decode_launch", "serve.decode_consume"]
    launch = kids[roots[0]["span_id"]][0]
    assert launch["attrs"]["steps"] == 4
    consume = kids[roots[2]["span_id"]][1]
    assert set(consume["attrs"]) <= {"device_wait_s", "host_blocked_s"}
    assert "device_wait_s" in consume["attrs"]
    # The first dispatch found the ring empty: its host time blocked the device.
    assert roots[0]["attrs"]["host_blocked_s"] > 0


def test_every_child_lies_inside_its_parent(model, tracer):
    eng = engine(model, slots=3)
    for i in range(3):
        eng.submit(prompt(10 + 7 * i, i), 6 + 3 * i)
        eng.step_n(2)
    eng.run_until_drained()
    spans = tracer.spans()
    by_id, _ = tree(spans)
    nested = 0
    for s in spans:
        parent = by_id.get(s["parent_id"])
        if parent is None:
            continue
        (a, b), (pa, pb) = interval(s), interval(parent)
        assert pa - EPS <= a <= b <= pb + EPS, (s["name"], parent["name"])
        nested += 1
    assert nested > 10


def test_stamps_inside_the_engine_calls_fall_inside_their_spans(model, tracer, monkeypatch):
    """time.time_ns() read inside each forward_decode_paged, prefill and
    pool scatter lies inside the interval of the span that holds it."""
    stamps = {"serve.decode_launch": [], "serve.prefill": [], "serve.insert": []}

    def stamping(fn, name):
        def wrapped(*a, **k):
            stamps[name].append(time.time_ns())
            out = fn(*a, **k)
            stamps[name].append(time.time_ns())
            return out
        return wrapped

    monkeypatch.setattr(paged_engine, "forward_decode_paged",
                        stamping(paged_engine.forward_decode_paged, "serve.decode_launch"))
    monkeypatch.setattr(paged_engine, "forward_prefill",
                        stamping(paged_engine.forward_prefill, "serve.prefill"))
    monkeypatch.setattr(paged_engine, "paged_insert",
                        stamping(paged_engine.paged_insert, "serve.insert"))
    eng = engine(model)
    eng.submit(prompt(9), 9)
    eng.submit(prompt(17, 1), 5)
    eng.run_until_drained()
    spans = tracer.spans()
    for name, got in stamps.items():
        assert got, name
        windows = [interval(s) for s in spans if s["name"] == name]
        for t in got:
            assert any(a * 1e9 - EPS * 1e9 <= t <= b * 1e9 + EPS * 1e9 for a, b in windows), name


def test_sections_land_on_their_spans_and_sum_within_them(model, tracer):
    kind = model[0]
    eng = engine(model)
    eng.submit(prompt(12), 12)
    eng.step_n(4)
    eng.run_until_drained()
    spans = tracer.spans()
    launches = [s for s in spans if s["name"] == "serve.decode_launch"]
    prefills = [s for s in spans if s["name"] == "serve.prefill"]
    ffn = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine") if kind == "moe" \
        else ("ffn",)
    for s in launches + prefills:
        a = s["attrs"]
        assert sum(a.get(f"{k}_s", 0.0) for k in TOP) <= s["duration_s"] + EPS
        per = a.get("steps", 1)
        assert a["attn_n"] == N_LAYERS * per
        for k in ffn:
            assert a[f"{k}_n"] == N_LAYERS * per and a[f"{k}_s"] >= 0
        assert a["lm_head_n"] == per and a["sample_n"] == per
    assert sum(s["attrs"]["steps"] for s in launches) == eng.stats["decode_steps"]
    for s in spans:
        if s["name"] not in ("serve.decode_launch", "serve.prefill"):
            assert not any(k.endswith("_n") for k in s["attrs"]), s["name"]


def test_moe_sections_only_on_the_moe_config(model, tracer):
    kind = model[0]
    eng = engine(model)
    eng.submit(prompt(12), 6)
    eng.run_until_drained()
    keys = set().union(*(s["attrs"] for s in tracer.spans()))
    moe = {k for k in keys if k.startswith("moe_")}
    if kind == "moe":
        assert moe == {f"moe_{p}_{u}" for p in ("route", "dispatch", "experts", "combine")
                       for u in ("s", "n")}
        assert "ffn_s" not in keys
    else:
        assert not moe and "ffn_s" in keys


def test_dequant_copy_counts_its_bytes(tracer):
    """The bf16 copy a product over MAX_ROWS takes on CUDA. On the CPU a
    quantized product always runs int8_matmul's plain version (quant.py's
    routes), so the route cannot be reached here: the copy is driven
    directly, and a CPU product over MAX_ROWS is shown to write nothing."""
    w = quant.quantize_array(torch.randn(48, 32))
    with tracer.span("serve.prefill") as sp:
        out = quant.dequant_copy(w.q, torch.bfloat16)
        quant.dequant_copy(w.q, torch.bfloat16)
        quant.matmul(torch.randn(quant.MAX_ROWS + 1, 32), w)
    assert out.dtype == torch.bfloat16 and torch.equal(out.float(), w.q.float())
    assert sp.attrs["dequant_bytes"] == 2 * 48 * 32 * 2
    assert sp.attrs["dequant_n"] == 2 and sp.attrs["dequant_s"] >= 0


def test_sections_nest_on_the_innermost_span(tracer):
    with tracer.span("outer") as outer:
        with tracer.section("a"):
            with tracer.span("inner") as inner:
                with tracer.section("b"):
                    pass
                with tracer.section("b"):
                    pass
    assert set(outer.attrs) == {"a_s", "a_n"} and outer.attrs["a_n"] == 1
    assert set(inner.attrs) == {"b_s", "b_n"} and inner.attrs["b_n"] == 2
    assert outer.attrs["a_s"] >= inner.duration_s >= inner.attrs["b_s"]


def drive_flushes(model):
    """An engine run through each flush cause; returns the flush spans'
    causes in order."""
    eng = engine(model, slots=2, num_blocks=9)  # 8 blocks of 8 rows
    a = eng.submit(prompt(10), 9)               # 3 blocks (bucket 16, 19 rows)
    assert eng.submit(prompt(10, 1), 30) is not None  # 5 blocks: slots and pool full
    eng.step_n(4)
    assert eng.submit(prompt(10, 2), 4) is None  # slots: the flush retires nobody
    eng.step_n(4)                               # a's last 4 steps in flight
    assert eng.result(a) is not None            # result: a finished inside the chunk
    eng.step_n(4)
    assert eng.submit(prompt(20, 3), 8) is None  # blocks: 4 wanted, 3 free after the flush
    eng.run_until_drained()                     # bound: the completion bound is spent
    return [s["attrs"]["cause"] for s in trace.TRACER.spans()
            if s["name"] == "serve.decode_flush"]


def test_flushes_name_their_cause(model, tracer):
    causes = drive_flushes(model)
    assert causes[:3] == ["slots", "result", "blocks"] and set(causes[3:]) == {"bound"}
    spans = tracer.spans()
    by_id, kids = tree(spans)
    flushes = [s for s in spans if s["name"] == "serve.decode_flush"]
    for f in flushes:
        got = [k["name"] for k in kids.get(f["span_id"], [])]
        assert got and set(got) == {"serve.decode_consume"}, f["attrs"]
    # A flush from result() runs outside any other span: a root.
    assert all(f["parent_id"] is None for f in flushes if f["attrs"]["cause"] == "result")
    assert all(by_id[f["parent_id"]]["name"] == "serve.admission"
               for f in flushes if f["attrs"]["cause"] in ("slots", "blocks"))


def test_speculation_flushes_under_the_spec_cause(model, tracer):
    eng = engine(model)
    pat = np.tile(prompt(6), 4)
    rid = eng.submit(pat, 20)
    eng.step_n(2)
    eng.run_until_drained_speculative(gamma=3, ngram=2)
    assert eng.result(rid) is not None
    causes = [s["attrs"]["cause"] for s in tracer.spans() if s["name"] == "serve.decode_flush"]
    assert "spec" in causes


def test_tracer_off_returns_the_shared_noop_and_writes_nothing(model, monkeypatch):
    off = trace.Tracer(enabled=False)
    monkeypatch.setattr(trace, "TRACER", off)
    with trace.span("serve.admission") as sp:
        assert sp is trace.NOOP and trace.section("attn") is trace.NOOP
    eng = engine(model)
    eng.submit(prompt(12), 8)
    eng.step_n(4)
    eng.run_until_drained()
    assert off.spans() == [] and trace.NOOP.to_dict()["attrs"] == {}
    assert not getattr(trace.NOOP, "__dict__", {})


def test_section_is_the_noop_without_a_live_span_or_when_sampled_out(monkeypatch):
    on = trace.Tracer(enabled=True, sample_rate=1.0)
    monkeypatch.setattr(trace, "TRACER", on)
    assert trace.section("attn") is trace.NOOP  # no live span: training, say
    with trace.span("root"):
        assert trace.section("attn") is not trace.NOOP
    out = trace.Tracer(enabled=True, sample_rate=0.0)
    monkeypatch.setattr(trace, "TRACER", out)
    with trace.span("root") as root:
        assert root is not trace.NOOP and trace.current_span() is trace.NOOP
        assert trace.section("attn") is trace.NOOP
        with trace.section("attn") as sec:
            sec.add(dequant_bytes=1)
    assert out.spans() == []


def test_training_forward_writes_no_section(tracer):
    cfg, params = tiny(moe=True)
    tl.forward(params, torch.randint(1, 63, (1, 8)))
    assert tracer.spans() == []
