"""The comparison that decides `correct` for a served model.

After the window has closed (and the program's state is freed), a sample
of the requests the window completed (a dozen, drawn from the seed, always
with the longest of them: some hundreds to a few thousand served tokens
from as many slots) is run through the plain reference
(reference/model.py): one forward over each prompt followed by its served
tokens. At every served token the reference gives the gap by which that
token's logit lies below the reference's best logit at that position
(0 where the served token is the reference's own choice). Greedy decoding
serves the program's argmax, so a sound program's gaps are the size of its
rounding; a wrong token, a skipped or stale step, or a lost row of the
batch shows as a gap of the size of the logits' spread.

The numbers compared, each against the cell's limits file
(limits/<cell>.json, set from the readings PERF.md gives):
  * max_logit_gap: the widest gap over the sample;
  * mean_logit_gap: the mean gap over the sample's served tokens;
  * bad_completions: completed requests whose token count or ids are
    wrong (exact: limit 0).

The control (calibrate.py) is the reference in the program's place at the
next precision below the configuration's: int4 weights for int8. It reads
the f32 reference's gap of the token the int4 forward puts first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from port_bench.reference import model as reference
from port_bench.traffic import seed_entropy

SAMPLE_REQUESTS = 12  # completed requests the sample holds (all, where fewer completed)


def pick_sample(done: Sequence[tuple], seed: int, most: int = SAMPLE_REQUESTS) -> list[tuple]:
    """From completed (prompt, served tokens) pairs: the one with the most
    served tokens (the longest prompt on a tie), then others in an order
    drawn from the seed, `most` requests in all."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i][1]), len(done[i][0])))
    order = [longest] + [int(i) for i in np.random.default_rng(
        [seed_entropy(seed), 4]).permutation(len(done)) if i != longest]
    return [done[i] for i in order[:most]]


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref [m, V] f32 logits, served [m] token ids -> the gap of each."""
    return ref.max(dim=-1).values - ref.gather(1, served[:, None].long())[:, 0]


def compare(shape: dict, seed: int, sample: Sequence[tuple], device, kv_int8: bool = True,
            control: bool = False) -> dict:
    """The program's numbers over `sample` and, with `control`, the
    control's: {"max_logit_gap", "mean_logit_gap", "positions"} and
    {"control_max_logit_gap", "control_mean_logit_gap"}."""
    seqs = [np.concatenate([np.asarray(p), np.asarray(t[:-1], dtype=np.int32)]) for p, t in sample]
    first = [len(p) - 1 for p, _ in sample]
    precisions = ("int8", "int4") if control else ("int8",)
    out = reference.logits(shape, seed, seqs, first, device, kv_int8, precisions)
    gaps, ctl = [], []
    for i, (_, toks) in enumerate(sample):
        ref = out["int8"][i]
        gaps.append(served_gaps(ref, torch.as_tensor(np.asarray(toks), device=ref.device)))
        if control:
            ctl.append(served_gaps(ref, out["int4"][i].argmax(dim=-1)))
    g = torch.cat(gaps)
    res = {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
           "positions": int(g.numel())}
    if control:
        c = torch.cat(ctl)
        res |= {"control_max_logit_gap": float(c.max()), "control_mean_logit_gap": float(c.mean())}
    return res


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number the limits
    file bounds; a number with no reading fails."""
    compared, ok = {}, True
    for name, limit in limits["limits"].items():
        value = numbers.get(name)
        compared[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and value <= limit
    return ok, compared
