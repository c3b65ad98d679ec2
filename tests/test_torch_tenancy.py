"""Multi-tenant QoS of the port (``server/tenancy.py``): every case of
``tests/test_tenancy.py`` runs on ``pilosa_tpu_torch`` — per-index
admission token buckets (429 + Retry-After, distinct from the 503
overload shed), virtual-time weighted-fair scheduling in the pipeline
class queues, HbmGovernor per-index quotas with over-quota-first relief,
and per-tenant SLO/waterfall attribution."""

from port_reference import exec_against_port

exec_against_port("test_tenancy", globals())
