"""Drivers: one module a kind of traffic, named by the ``driver`` key of a
workload file. Each exposes ``run(ctx) -> harness.Outcome``."""
