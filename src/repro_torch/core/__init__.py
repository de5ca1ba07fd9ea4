"""CLUGP core on PyTorch: the three-pass partitioner's device pipeline."""
from .graphgen import Graph, web_graph, social_graph, rmat, barabasi, bfs_order, random_stream  # noqa: F401
from .clustering import (ClusteringResult, compact_labels,  # noqa: F401
                         default_vmax, streaming_clustering)
from .game import game_rounds, greedy_assign  # noqa: F401
from .transform import majority_vertex_map, transform  # noqa: F401
from .pipeline import CLUGPConfig, CLUGPResult  # noqa: F401
from .stages import (StageCtx, StageSet, PipelineOut, TORCH_STAGES,  # noqa: F401
                     StreamState, incremental_assign, restream_assign,
                     restream_loop, run_clugp_body, stream_state)
from .partitioner import BACKENDS, partition, resolve_device  # noqa: F401
from . import metrics  # noqa: F401
