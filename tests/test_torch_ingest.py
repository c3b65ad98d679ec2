"""Durable streaming ingest of the port (``server/ingest.py`` over the
fragment's group commit): every case of ``tests/test_ingest.py`` runs on
``pilosa_tpu_torch`` — the group-commit wire format, torn op-log tail
recovery, storage fault injection, the write-ahead queue's
ack/backpressure contract, and the HTTP ingest surface. An ACKED write
replays after any crash; a torn trailing record truncates cleanly."""

from port_reference import exec_against_port

exec_against_port("test_ingest", globals())
