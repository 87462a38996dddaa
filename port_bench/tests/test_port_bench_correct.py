"""The comparison that decides `correct`, at a size a CPU test run holds:
the port's plain path agrees with the frozen reference; the control (the
reference at int4 weights in the program's place) fails the cell's limits;
and a run with its timed path broken underneath (the harness's look for a
chip skipped) comes out not correct, for each fault a one-chip serving
cell can have, and for a product that reads another output channel's
scale and a norm that drops its weight. The tests marked `gpu` run the
same on the card."""

import itertools

import numpy as np
import pytest
import torch

from port_bench import harness, judge, spec
from port_bench.tests.tiny import tiny_cell
from lws_tpu_torch.models import llama, quant
from lws_tpu_torch.serving import paged_engine

SEED = 2**31 + 4242


def limits(cell_name: str) -> dict:
    return spec.read_json(spec.PKG / "limits" / f"{cell_name}.json")


def run(cell, device="cpu", seconds=0.8, control=False):
    """One run whose clock ticks 1 ms a reading, so the window holds the
    same iterations however busy the machine is."""
    ticks = itertools.count()
    clock = lambda: next(ticks) * 1e-3  # noqa: E731
    return harness.run_cell(cell, SEED, seconds, False, torch.device(device), clock(),
                            control=control, clock=clock)


@pytest.mark.parametrize("moe", [False, True])
def test_the_plain_path_agrees_with_the_reference(moe):
    cell = tiny_cell(moe=moe, limits=limits("mixtral8x7b.chat" if moe else "mistral7b.chat"))
    out = run(cell)
    assert out["line"]["correct"], out["line"]["compared"]
    assert out["numbers"]["positions"] >= 40
    assert out["numbers"]["bad_completions"] == 0


@pytest.mark.parametrize("cell_name,moe", [("mistral7b.chat", False),
                                           ("mixtral8x7b.chat", True)])
def test_the_control_fails_the_limits(cell_name, moe):
    lim = limits(cell_name)
    out = run(tiny_cell(moe=moe, limits=lim), control=True)
    n = out["numbers"]
    ctl = {"max_logit_gap": n["control_max_logit_gap"],
           "mean_logit_gap": n["control_mean_logit_gap"], "bad_completions": 0}
    ok, _ = judge.verdict(ctl, lim)
    assert not ok, (ctl, lim)


def on_decode(wrap):
    """A fault of the decode step: `wrap(forward_decode_paged)` in its place."""
    def install(monkeypatch):
        monkeypatch.setattr(paged_engine, "forward_decode_paged",
                            wrap(paged_engine.forward_decode_paged))
    install.__name__ = wrap.__name__
    return install


@on_decode
def stale_state(orig):
    """A decode step that returns its state unchanged: the new K/V rows
    are written to a copy that is thrown away."""
    def step(params, tokens, cache, table, pos_b, plain=False):
        scratch = type(cache)(*(None if t is None else t.clone() for t in
                                (cache.k, cache.v, cache.k_scale, cache.v_scale)))
        logits, _ = orig(params, tokens, scratch, table, pos_b, plain)
        return logits, cache
    return step


@on_decode
def half_batch(orig):
    """Half the batch left out: its rows get the mean of the rest's logits."""
    def step(*args, **kw):
        logits, cache = orig(*args, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, cache
    return step


@on_decode
def altered_token(orig):
    """A token altered where it is produced: every third step, each slot's
    argmax moves to the next id."""
    calls = [0]

    def step(*args, **kw):
        logits, cache = orig(*args, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            top = logits.argmax(dim=-1)
            rows = torch.arange(logits.shape[0])
            logits[rows, (top + 1) % logits.shape[1]] = logits[rows, top] + 1.0
        return logits, cache
    return step


def wrong_scale_index(monkeypatch):
    """Every quantized product, prefill and decode, reads the scale of the
    output channel next to its own."""
    orig = llama.matmul

    def matmul(x, w, *args, **kw):
        if isinstance(w, quant.QuantizedArray):
            w = quant.QuantizedArray(w.q, torch.roll(w.scale, 1, dims=-1))
        return orig(x, w, *args, **kw)
    monkeypatch.setattr(llama, "matmul", matmul)


def dropped_norm_weight(monkeypatch):
    """Every RMSNorm normalizes and leaves out its weight."""
    orig = llama.rms_norm
    monkeypatch.setattr(llama, "rms_norm", lambda x, w, eps: orig(x, torch.ones_like(w), eps))


@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_token, wrong_scale_index,
                                   dropped_norm_weight])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run(tiny_cell(limits=limits("mistral7b.chat")))
    assert not out["line"]["correct"], out["line"]["compared"]


def test_the_sample_holds_the_longest_request_and_a_dozen():
    done = [(np.arange(5 + i % 3), np.arange(n)) for i, n in enumerate(range(2, 40))]
    picked = lambda seed: [len(t) for _, t in judge.pick_sample(done, seed)]  # noqa: E731
    got = picked(SEED)
    assert len(got) == judge.SAMPLE_REQUESTS == 12 and got[0] == 39 and len(set(got)) == 12
    assert picked(SEED) == got and picked(SEED + 1) != got
    assert len(judge.pick_sample(done[:5], SEED)) == 5


@pytest.mark.gpu
def test_on_the_card_the_kernels_path_agrees_with_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the card run: python -m pytest port_bench/tests -m gpu")
    cell = tiny_cell(limits=limits("mistral7b.chat"))
    cell.config["hidden_size"] = 1024  # head_dim 128 for the kernels: 8 heads
    cell.config.update({"num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 128})
    out = run(cell, device="cuda")
    assert out["line"]["correct"], out["line"]["compared"]
