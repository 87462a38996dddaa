"""The port's tracer against the JAX package's (lws_tpu_torch/core/trace.py
against lws_tpu/core/trace.py), on the CPU: the decorator, `record` of a
peer's spans, `walk`'s order, and the JSONL files, which each package reads
from the other (`export_jsonl` into `read_jsonl`).

Every case runs the same steps on a private `Tracer()` of each package;
span and trace ids and the clocks are drawn per run, so the records are
compared with ids renamed in order of first appearance and the two clock
fields taken out."""

from __future__ import annotations

import json

import pytest

from lws_tpu.core import trace as jtrace
from lws_tpu_torch.core import trace as ptrace
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

# The module-level cases finish spans on both process tracers, whose
# journey feeds (if another file installed them) are taken back off.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

SIDES = {"jax": jtrace, "port": ptrace}
CLOCKS = ("start_unix", "duration_s")


def _shape(records: list) -> list:
    """Records with ids renamed in order of first appearance and the clock
    fields dropped: what two runs of the same steps must share."""
    names: dict = {}

    def rename(x):
        if x is None:
            return None
        return names.setdefault(x, f"id{len(names)}")

    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in CLOCKS}
        for key in ("trace_id", "span_id", "parent_id"):
            r[key] = rename(r.get(key))
        out.append(r)
    return out


def _drive(t) -> tuple:
    """One request's tree: a decorated root, a traced child, a failing
    child, and a peer's subtree that rides back and is `record`ed.
    Returns (the tracer, the root's span id, the peer's records)."""
    tracer = t.Tracer(enabled=True)

    @tracer.trace()
    def handle(n):
        with tracer.span("admit", n=n) as sp:
            sp.set(queued=1)
        try:
            with tracer.span("prefill"):
                raise ValueError("boom")
        except ValueError:
            pass
        return peer_leg(n)

    def peer_leg(n):
        # A peer process seeds its subtree from our context; its records
        # come back over the result channel.
        peer = t.Tracer(enabled=True)
        with peer.span("serve.decode", parent=tracer.current_context()) as sp:
            with peer.span("kv.deserialize"):
                pass
            sp.add(tokens=n)
        return [dict(r) for r in peer.spans()]

    @tracer.trace("named.root", route="r1")
    def outer(n):
        return handle(n)

    peer = outer(3)
    for rec in peer:
        tracer.record(rec)
    spans = tracer.spans()
    root = next(s for s in spans if s["name"] == "named.root")
    return tracer, root["span_id"], peer


@pytest.fixture(scope="module")
def driven():
    return {name: _drive(t) for name, t in SIDES.items()}


def test_decorator_and_record_build_the_same_tree(driven):
    shapes = {name: _shape(tr.spans()) for name, (tr, _, _) in driven.items()}
    assert shapes["port"] == shapes["jax"]
    names = [r["name"] for r in shapes["port"]]
    # The decorator names an undecorated span after the function's
    # qualified name; the peer's two spans joined the ring by `record`.
    assert names == ["admit", "prefill", "_drive.<locals>.handle", "named.root",
                     "kv.deserialize", "serve.decode"]
    recs = {r["name"]: r for r in shapes["port"]}
    assert recs["prefill"]["status"] == "error"
    assert recs["named.root"]["attrs"] == {"route": "r1"}
    assert recs["serve.decode"]["attrs"] == {"tokens": 3}
    assert ptrace.connected_tree(driven["port"][0].spans())


def test_record_copies_the_peer_record(driven):
    tracer, _, peer = driven["port"]
    peer[0]["name"] = "changed after the record"
    assert all(r["name"] != "changed after the record" for r in tracer.spans())


def test_walk_visits_the_subtree_depth_first_in_jax_order(driven):
    orders = {}
    for name, (tracer, root, _) in driven.items():
        spans = tracer.spans()
        orders[name] = [s["name"] for s in SIDES[name].walk(spans, root)]
        # A walk from a leaf yields the leaf alone; an unknown id nothing.
        leaf = next(s for s in spans if s["name"] == "kv.deserialize")
        assert [s["name"] for s in SIDES[name].walk(spans, leaf["span_id"])] == ["kv.deserialize"]
        assert list(SIDES[name].walk(spans, "no-such-span")) == []
    assert orders["port"] == orders["jax"]
    assert orders["port"][0] == "named.root" and len(orders["port"]) == 6


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_jsonl_written_by_one_package_reads_back_in_the_other(driven, writer, reader, tmp_path):
    tracer = driven[writer][0]
    path = str(tmp_path / "spans.jsonl")
    n = tracer.export_jsonl(path)
    assert n == len(tracer.spans()) == 6
    back = SIDES[reader].Tracer.read_jsonl(path)
    assert back == json.loads(json.dumps(tracer.spans()))
    assert SIDES[reader].connected_tree(back)
    # What one package reads back, the other records: the round trip is
    # the tree that was written.
    again = SIDES[reader].Tracer(enabled=True)
    for rec in back:
        again.record(rec)
    assert again.spans() == back


def test_module_level_traced_and_record_use_the_process_tracer(monkeypatch):
    """`traced` and `record` go to the module's TRACER (a fresh one here: the
    process tracer's ring may be full from earlier tests in the worker)."""
    shapes = {}
    for name, t in SIDES.items():
        monkeypatch.setattr(t, "TRACER", t.Tracer(enabled=True))

        @t.traced("module.traced", k=1)
        def work():
            return t.current_context()

        ctx = work()
        t.record({"trace_id": ctx["trace_id"], "span_id": "peer", "parent_id": ctx["span_id"],
                  "name": "peer", "attrs": {}})
        new = t.spans()
        shapes[name] = _shape(new)
        assert t.connected_tree(new) and [s["name"] for s in new] == ["module.traced", "peer"]
    assert shapes["port"] == shapes["jax"]
