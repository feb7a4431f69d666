"""Readers of the benchmark's metrics, one module a metric, found by the
metric's name in BENCHMARK.json.  Each has ``read(run)``, which takes the
run's record (``harness.Run``) and returns the number, or None where the
run holds nothing to read it from; a share of a roofline or of a peak is
never given as 0."""
