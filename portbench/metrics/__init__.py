"""Readers of the benchmark's metrics, one module per metric, found by
the metric's name in BENCHMARK.json. Each has `read(view) -> float |
None`: `view` holds the window's spans, counts and (in a traced run) the
profiler's readings; None means the metric has nothing to read in this
cell and is left out of the result."""
