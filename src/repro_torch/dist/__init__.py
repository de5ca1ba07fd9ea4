"""Mirror-sync exchange of the vertex-cut engine (stacked and per-rank
halves), the collectives and the compressors; the named-axis sharding
rules of the LM (``sharding``: the rule tables, ``shard``,
``use_rules``), sequence-parallel decode (``decode``) and pipeline
stages (``pipeline_parallel``)."""
from .sharding import (CP_SERVE_RULES, MULTI_POD_RULES,  # noqa: F401
                       SINGLE_POD_RULES, shard, use_rules)
