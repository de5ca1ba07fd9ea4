"""Mirror-sync exchange of the vertex-cut engine (stacked form)."""
