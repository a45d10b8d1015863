"""Device grid operators of the PromQL path (grid, windows, functions)."""
