"""CLUGP core on PyTorch: the three-pass partitioner's device pipeline,
its host oracle, the baselines and the theory quantities."""
from .graphgen import Graph, web_graph, social_graph, rmat, barabasi, bfs_order, random_stream  # noqa: F401
from .clustering import (ClusteringResult, compact_labels,  # noqa: F401
                         default_vmax, streaming_clustering,
                         streaming_clustering_np)
from .game import (ClusterGraph, best_response_rounds, contract,  # noqa: F401
                   game_rounds, game_rounds_gs, greedy_assign,
                   greedy_assign_np)
from .transform import (majority_vertex_map, majority_vertex_map_np,  # noqa: F401
                        transform, transform_np)
from .pipeline import CLUGPConfig, CLUGPResult  # noqa: F401
from .stages import (StageCtx, StageSet, PipelineOut, TORCH_STAGES,  # noqa: F401
                     HOST_STAGES, StreamState, incremental_assign,
                     restream_assign, restream_loop, run_clugp_body,
                     stream_state)
from .partitioner import (BACKENDS, partition, partition_sweep,  # noqa: F401
                          resolve_device)
from . import baselines, metrics, theory  # noqa: F401
