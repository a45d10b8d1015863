"""PromQL for the port: the parser, the engine and the device fast path."""
