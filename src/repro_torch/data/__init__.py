"""Synthetic data of the port (counterpart of ``repro.data``)."""
from .pipeline import DataConfig, batch_at, graph_edge_shards  # noqa: F401
