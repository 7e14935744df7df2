"""One reader a metric: `port_bench/metrics/<metric>.py` defines `read(ctx)`, which returns the metric's value from
the run's context (`harness.py` documents its keys), or None where the run has nothing to read for it: the harness
then leaves the metric out of the result line. The harness finds a reader by the metric's name in BENCHMARK.json."""
