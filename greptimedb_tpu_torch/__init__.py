"""greptimedb_tpu_torch: the PyTorch/CUDA port of greptimedb_tpu.

The port covers the single-card write -> compaction -> RANGE query
path: runs appended to an in-memory region, per-window compaction through
the device merge program and the merge-gather kernel, and RANGE queries
over device-resident cell-state grids whose grouped fold runs the blocked
fold kernel, sharded over a mesh with the ring kernels; and PromQL
(promql/engine.PromEngine) over device-resident selector grids, one
device or sharded, whose sharded topk merges candidates with the topk
merge kernel. Durable storage (WAL, SSTs, manifest, engine) sits under
a catalog, and the standalone server (instance.Standalone with
servers/http.HttpServer) takes SQL statements, InfluxDB line protocol,
Prometheus remote write and the Prometheus HTTP API. Entry points run on
CUDA unless the caller passes ``device="cpu"``; there the kernels' plain
PyTorch versions run.
"""
