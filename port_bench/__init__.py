"""The benchmark of the PyTorch and CUDA port (`lws_tpu_torch`).

One run serves one cell of `BENCHMARK.json` (a model configuration under a
traffic mix) through `lws_tpu_torch.serving.paged_engine.PagedBatchEngine`
on the card, in a closed loop, and prints one JSON line:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix, one cell's
correctness limits or one per-layer metric is a file of its own, found by
the name `BENCHMARK.json` gives it:

    port_bench/configs/<config>.json     sizes, published keys, engine settings
    port_bench/traffic/<traffic>.json    parameters of the one general generator
    port_bench/limits/<cell>.json        the limits of the comparison deciding `correct`
    port_bench/metrics/<metric>.py       a reader of one per-layer metric

The yardstick lives here and nowhere in the program: traffic generation,
the seeded weight maker, the plain f32 reference (`reference/`), the
comparison (`judge.py`), the table of peaks and the operation and byte
counts (`reckon.py`), and the reduction of a profiler slice (`profiling.py`).
Nothing in this package imports `jax` or the JAX package; `reference/`
imports nothing of `lws_tpu_torch` either.
"""
