"""Mirror-sync exchange of the vertex-cut engine (stacked and per-rank
halves), the collectives and the compressors."""
