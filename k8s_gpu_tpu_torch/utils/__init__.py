"""Pure-Python utilities of the port: its own copies of the reference's
metrics registry, trace-context helpers, clocks, fault injection, goodput
ledger and phase profiler."""
