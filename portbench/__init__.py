"""The port's benchmark: cells of BENCHMARK.json, run by run.py."""
