"""Auxiliary components the storage, executor and server layers use:
metrics, tracing, the event journal, the heat ledger, error types, the
protobuf codecs, logging, stats sinks, SLO monitoring and the
performance-attribution profiler (copies of the ``pilosa_tpu``
modules)."""
