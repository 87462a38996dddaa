"""Prefix cache: `PagedBatchEngine(prefix_cache=True)` (digest chain,
refcounts, LRU). The prompt tokens served from cached blocks over the
prompt tokens submitted in the window, from the engine's own counter
`stats_prefix["hit_tokens"]` read around each submit."""

NAME = "prefix_hit_pct"
UNIT = "%"
LAYER = "prefix cache (serving/paged_engine.py prefix_cache=True)"
SOURCE = "program_counter"
MOVES = "ttft_p90_ms"


def read(rec):
    prompt = sum(a.plen for a in rec.admissions)
    return 100.0 * sum(a.hit for a in rec.admissions) / prompt if prompt else None
