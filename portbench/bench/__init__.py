"""The harness: builds a cell of `repro_torch` from the benchmark's data,
drives it, times it from outside and reads its counters."""
