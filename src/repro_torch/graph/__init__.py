"""Vertex-cut graph engine of the port: layout tables and the stacked
GAS driver."""
from .partition import PartitionLayout, build_layout  # noqa: F401
from .engine import (GASProgram, pagerank_program, reference_pagerank,  # noqa: F401
                     simulate_gas)
