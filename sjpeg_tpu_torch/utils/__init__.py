"""Support utilities: profiling, tracing, counters."""
