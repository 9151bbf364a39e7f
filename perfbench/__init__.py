"""The port's benchmark: harness, configurations, traffic mixes, metric
readers and the plain reference (``perfbench/README.md``)."""
