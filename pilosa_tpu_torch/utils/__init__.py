"""Auxiliary components the storage and executor layers use: metrics,
tracing, the event journal, the heat ledger, error types and the
protobuf meta codec (copies of the ``pilosa_tpu`` modules)."""
