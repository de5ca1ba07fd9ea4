"""Vertex-cut graph engine of the port: layout tables, the stacked and
the per-rank GAS drivers and the program library."""
from .partition import PartitionLayout, build_layout  # noqa: F401
from .engine import (CC_PROGRAM, CC_SENTINEL, DEGREE_PROGRAM,  # noqa: F401
                     PROGRAM_NAMES, FusedGAS, GASProgram,
                     bfs_program, centrality_program, default_num_seeds,
                     fuse_programs, gas_step_for_dryrun, get_program,
                     labelprop_program, pagerank_program,
                     pagerank_step_for_dryrun, ppr_program, reference_bfs,
                     reference_cc, reference_centrality, reference_degree,
                     reference_labelprop, reference_pagerank, reference_ppr,
                     reference_sssp, shard_map_cc, shard_map_gas,
                     shard_map_gas_many, shard_map_pagerank, simulate_cc,
                     simulate_gas, simulate_gas_many, simulate_pagerank,
                     sssp_program)
