"""API + HTTP + server runtime (L6/L7), one node."""

from pilosa_tpu_torch.server.api import API, APIError, NotFoundError
from pilosa_tpu_torch.server.config import ClusterConfig, Config, TLSConfig
from pilosa_tpu_torch.server.deadline import Deadline, DeadlineExceeded
from pilosa_tpu_torch.server.http_handler import Handler, encode_result, make_http_server
from pilosa_tpu_torch.server.pipeline import Overloaded, QueryPipeline
from pilosa_tpu_torch.server.server import Server

__all__ = [
    "API",
    "APIError",
    "ClusterConfig",
    "TLSConfig",
    "Config",
    "Deadline",
    "DeadlineExceeded",
    "Handler",
    "NotFoundError",
    "Overloaded",
    "QueryPipeline",
    "Server",
    "encode_result",
    "make_http_server",
]
