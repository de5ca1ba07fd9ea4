"""Meshes of ranks (port of ``repro.launch.mesh``).

The mesh type, the transport choice and the rank spawner live in
``dist.mesh``; the launchers and users take the constructors from here,
as in the reference.
"""
from ..dist.mesh import (make_graph_mesh, make_production_mesh,
                         make_stream_mesh, make_test_mesh)

__all__ = ["make_graph_mesh", "make_production_mesh", "make_stream_mesh",
           "make_test_mesh"]
