"""The benchmark's harness: what is the same for every cell.

``spec`` reads ``BENCHMARK.json`` and finds a cell's configuration,
workload and metric readers by name; ``session`` builds the program's
trial as its ``train()`` does, runs the checked first steps and the
measured window; ``trace`` reads the profiler; ``check`` holds the
program's first steps to the reference; ``weights`` makes the weights
that both sides start from.
"""
