#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of greptimedb_tpu on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--hosts 4000] [--hours 12]
                          [--mesh-hosts 8192] [--mesh-hours 6]
                          [--prom-series 1000000] [--hist-pods 12500]
                          [--rest-warm 5] [--server-hours 1]
                          [--flow-hours 2]
                          [--phases 1,14,17]

Phases (each failure raises; the script then exits non-zero and prints no
result line). `--phases` runs the listed phases only, with phase 1 and the
phases whose inputs they take (3, 4, 5 and 11 take phase 2's table; 8 and
9 phases 2 and 6; 10 and 18 phase 7; 15, 16 and 17 phase 14); by default
every phase runs. The kernels line then holds, and checks the launches of, the
kernels of the phases that ran. Query sessions (query/sessions.py) are off
in every phase but 17 and phase 7's repeated poll, so every warm call of
phases 1 to 16 runs its program, as before sessions existed.

1. build   — compile the CUDA kernels from greptimedb_tpu_torch's sources
             (one nvcc per source, all at once) and print the card's name
             and power limit as nvidia-smi reports them.
2. slice   — the port's main path at TSBS devops cpu-only size: 4000 hosts
             (each in one of TSBS's 9 AWS regions), 12 h at 10 s, ten
             usage_* float64 fields = 17.28 M rows. Every hour is written
             as four 15-minute runs plus a late re-delivery run (10% of the
             hour's keys, new values, higher seq) and a tombstone run (1%).
             Every 1 h window is compacted on the card (merge program + K1,
             verify=True against the host merge), the range grid is built,
             and two RANGE queries run: Q1 = TSBS double-groupby-all
             (avg of all ten fields RANGE 1h ALIGN 1h BY hostname) and Q2 =
             count/sum/min/max/avg/stddev_samp/first/last of usage_user
             RANGE 2h ALIGN 1h BY region (the grouped fold, through K2).
             Kernel launch counts are zeroed just before this phase and
             read just after it.
3. check   — Q1/Q2 equal the same port run on the CPU (exact for counts,
             min/max, first/last, presence; Q1's sums within the stated
             reduction-order bound) and Q1 equals numpy hourly means over
             the deduplicated rows (rtol 1e-5).
4. kernels — K1 and K2 at the shapes the main path gave them, held against
             their plain PyTorch versions on the same inputs (bit-exact),
             and timed with CUDA events beside their plain versions, one
             PyTorch library call computing the same function, and the
             card's bound for the work (K2's: the largest of its bytes,
             its adds and its longest chain of dependent adds, at the
             card's dependent-add latency, measured here first with one
             thread's chain of 2^20 adds).
5. profile — one warm Q1, Q2 and one window's merge under torch.profiler.
6. mesh    — the series-sharded RANGE path: TSBS devops at 8192 hosts (the
             JAX package's multichip probe size, past the planner's
             shard_min_series = 4096), 6 h at 10 s, written like phase 2
             and compacted on the card. Three engines run Q1 and Q2 cold,
             then warm (median of 5): one device; a mesh of the card named
             four times (four shards on one card) with default options,
             which must decide shard(large_grid) with the ring kernels;
             and the same mesh with kernels off (the gather twin). Q2 and
             Q1's keys, timestamps and presence must be bit-identical
             across the three; Q1's sums and means too, or within the
             reduction-order bound. Kernel counts are zeroed before each
             engine and read after it. Every shard lies on the one card, so
             the ring engine runs every ring in one launch: the fused ring
             kernel for each group fold, ring_pext_fused for each extreme
             and ring_psum_onehot_fused for each one-hot sum (12, 10 and 4
             per warm Q2), with no seed, continuation or hop combine; none
             of them may launch on the gather engine. Then each ring kernel
             at the shapes the mesh path gave it (the fused ring, fold_cont
             and block_partials also on edge bits and on misaligned rows,
             the fused ring against the hop ring; the hop combines on
             shards 0 and 1, their ring forms on all four) is held against
             its plain version and timed, with an empty kernel through the
             same launch path as the floor of a launch; one warm sharded Q2
             is profiled on every engine and on the hop ring (which must
             launch 12 seeds and 36 fold_cont per warm Q2, and the gather
             engine 48 block_partials); and each step of the kernels'
             host-side launch path is timed per call.
7. promql  — the PromQL fast path at the JAX package's PromQL benchmark
             size: 1,000,000 series (host_i, dc = i % 32), 10 samples at
             30 s, seed 11 (10 M rows), written through the port's Table.
             Four queries (sum by (dc) (rate(...[1m])), topk(5, ...),
             topk(100, ...), bottomk(100, ...), 8 steps) run through
             PromEngine.query_range on one device, on the card named four
             times with default options (shard(large_grid), the topk ring
             in one launch: ring_topk_merge_fused) and with kernels off
             (the gather twin), then the three topk queries on the ring
             engine with the ring hop by hop (merge_candidates): cold, warm
             (median of 5) and one profiled warm call each. The engines
             must agree bit for bit; the one-device topk results must equal
             the port on the CPU bit for bit, and the aggregate the CPU run
             within the bound of two matrix-product orders; per warm topk
             query the ring must launch ring_topk_merge_fused once and
             merge_candidates never, the hop ring merge_candidates three
             times, and the gather engine neither. Then both kernels at the
             path's shapes and on edge cases (ties, -inf, -0.0, NaN
             payloads and keys, unsorted, kl < k, 8 shards) are held
             against their plain versions and the ring also against the
             hop ring (bit for bit), and timed. Last, with query
             sessions on, topk(100, ...) twice on the ring engine: the
             first poll runs the program (one ring topk launch), the
             repeat is a session hit that launches nothing and answers
             the first's float64 bits.
8. sql     — SQL in: Instance(...).sql(text) answers bench.py's TSBS RANGE
             suite (the headline double-groupby-all and its nine device
             shapes, bench.py:2131-2201, cut to the table's hours) and Q2
             written as SQL, over the tables of phases 2 and 6 (no new
             ingest): one device on the 4000-host table; one device, the
             fused ring (the default), the hop ring (RingFoldCtx with
             fused=False: K2's seed, then fold_cont hop by hop) and the
             gather twin on the 8192-host table over make_mesh([dev] * 4),
             each Instance on the query engine of phase 2 or 6 (its grid
             built; the hop ring shares the ring engine's). Each query
             runs cold (the first SQL run on that engine), warm (median
             of 3) and once under the profiler. Every shape must take the
             device path with bench.py's row count at the table's size;
             the SQL Q1/Q2 must equal the plan-built Q1/Q2 of phases 2
             and 6 bit for bit; the four mesh engines must agree bit for
             bit (Q1-shaped means within the reduction-order bound); the
             fused kernel must launch on every sharded query that folds
             groups, and on no other engine; the one-ring forms only on
             the fused ring and the hop combines only on the hop ring (per
             warm SQL Q2: 10 ring extremes and 4 ring one-hot sums, or 30
             extreme and 12 one-hot add hops, and none on gather).
             Kernel counts are zeroed before the phase and read after it.
             Then the warm SQL Q2 runs on the fused ring and the hop ring
             in turn, 30 times each, for their host walls.
9. rows    — SQL beyond RANGE on the tables of phases 2 and 6: GROUP BY on
             the card (bench.py's GROUP BY hostname probe, a nine-op GROUP
             BY region and its twin without stddev_samp, which the mesh
             shards) on one device per table, and on the 8192-host table
             as the fused ring (the ring extremes and one-hot sums, 4r and
             5r), the hop ring (4 and 5 hop by hop) and gather: cold, warm
             (median of 3) and one profiled warm call each. Every GROUP BY
             must take the device path and launch kernel G; the four mesh
             engines must agree bit for bit; group counts must equal a
             numpy bincount over the scan and avg the float64 mean (1e-5
             relative); per warm sharded GROUP BY the ring must launch 8
             ring extremes and 2 ring one-hot sums, the hop ring 24 and 6
             hops, gather none. Then the host paths on the 4000-host table:
             TSBS high-cpu-1 and high-cpu-all (twice: the second served by
             the merged-scan cache) against a numpy filter of the scan, and
             five RANGE shapes the device grid declines, cut to the first
             3 hours, each on the host path (the OR shape also against its
             IN twin on the grid, 1e-5 relative). Then G (both forms) and
             Gt at the shapes the GROUP BYs gave them, G's sum form also
             on 2^25 rows with uniform random group ids (4096 groups x
             256 blocks), and both on edge inputs (NaN, +-0, +-inf,
             masked and empty groups, misaligned rows, one group; ids
             uniform or in series order) against their plain versions,
             bit for bit, and timed, with each timed shape's segment
             statistics; Gt must make one kernel launch a call. Kernel
             counts are zeroed before the phase and read after its main
             path.
10. promql_rest — the rest of PromQL on phase 7's prom_bench table (no new
             ingest) and bench.py's hist_bucket (bench.py:2575-2616:
             12,500 pods x 8 le buckets = 100,000 series over 50 services,
             10 samples at 30 s, seed 13), 8 steps as bench.py runs them:
             a. sum by (dc) (rate / last_over_time) — bench's vector_div,
                the fast binary, matmul branch;
             b. sum by (dc) (quantile_over_time(0.9, ...[2m])) — bench's
                metric, the blocked fast path;
             c. max by (dc) (deriv(...[2m])) — the linear fit, its extreme
                through ring_pext_fused (4r) on the ring engine;
             d. sum by (dc) (holt_winters(...[2m], 0.5, 0.5));
             e. histogram_quantile(0.9, sum by (le, svc) (rate(hist_bucket
                [1m]))) — bench's histogram, matmul branch;
             f. the same by (le, pod): 100,000 aggregated series put G S
                past 2^28, so the scatter branch sums through kernel G;
             g. the generic engine on hist_bucket: query_instant of e at
                the last step (off the grid) and query_range of
                rate(hist_bucket[1m]) > 1;
             h. query_instant of f: the generic engine's float64 vectors
                through the scatter branch, G's float64 sum form.
             The phase runs in the JAX package's x64 mode
             (QueryEngine(x64=True)); h runs once more without it: float32
             vectors through G's float32 sum form, one G launch a warm
             query, exact against the port on the CPU in the same mode.
             Each query runs on one device, the card named four times with
             default options (ring) and with kernels off (gather): cold,
             warm (median of --rest-warm) and one profiled warm call. The
             engines must agree bit for bit; one device must equal the
             port on the CPU bit for bit (c, f, g's range query, h) or
             within the matrix-product bound (a, b, d, which also stay
             within MATMUL_READ_K sqrt(n) u sum|x|, a limit set from
             readings; e and g's instant query through the bound of their
             bucket sums); per warm query G must launch once a step on f
             and h on every engine and never on the others,
             ring_pext_fused once on c on the ring engine and nowhere else
             (counts zeroed before each query). A probe at a's product
             shape shows whether the check can tell full float32 from
             TF32: exactly summable data must come out exact, and TF32
             must not. Then G at f's shape (float32) and at h's (float64)
             against its plain version (bit for bit), timed beside
             index_add_ and its bound; and K2 at c's shape (its count of
             1 M series, padded to 2^20 and the padding not listed, into
             33 groups over 8 steps; K2 must launch once a warm c on one
             device and never elsewhere), float32 on the query's own
             input and int32 on random words, against its plain version
             bit for bit, timed like phase 4's K2.
11. durable — durable storage: phase 2's writes (same seed, same rows in
             the same order, so the same sequences) through a table that
             a storage engine opened in a temporary data root, WAL on and
             wal_sync at its default (an acknowledged write survives a
             process crash, not a power loss): each hour's four runs as
             one batch (bench.py:2103-2120's hourly WAL batches), then its
             re-delivery and tombstone runs, a flush after each write.
             Compaction merges each hour's three SSTs on the card (K1 at
             262,144 rows and above, verified against the host merge).
             Hard checks: the full scan equals phase 2's in-memory region
             bit for bit after compaction and after a reopen; K1 launches
             once or more a merge of 262,144 rows or more; Q1 and Q2 on
             the recovered table equal phase 2's answers bit for bit (Q2
             through K2); after persist_entry a fresh engine's snapshot
             answers Q1/Q2 bit for bit without a rebuild; a child process
             writes one more 15-minute run and dies with os._exit before
             any flush, and the reopen reads back every acknowledged row;
             a second reopen after the recovery flush replays 0 WAL
             entries. Printed: rows/s with the WAL, flush and compaction
             seconds, K1 launches a merge, manifest load, WAL replay, SST
             restore (serial and pipelined) and open ms, snapshot cold
             time beside the rebuild's. K1 and K2 counts are zeroed before
             the phase and read after it. The data root is removed.
12. server — the standalone server: a Standalone on the card in a
             temporary data root serves HttpServer(inst, port=0); a second
             Standalone(device="cpu") in another root, the reference, runs
             in a worker process of its own and is fed the same payloads
             and statements through the same module functions (no HTTP)
             while the card's server works. Data: phase 2's TSBS devops
             rows (4000 hosts, 9 regions, 10 s, ten usage_* fields, same
             seed), cut to the first --server-hours 1 hour (1.44 M rows
             plus 10 % re-deliveries) for the script's time limit. CREATE
             TABLE goes over /v1/sql; each hour's four runs and its
             re-delivery go as line protocol (precision=ms) in bodies of
             10,000 lines (tsbs_load's --batch-size, formatted ahead on
             four worker processes) to /v1/influxdb/write, with an ADMIN
             flush_table after each run; the hour's tombstones are one
             DELETE ... WHERE hostname IN (1 % of the hosts) AND ts in the
             hour. Then ADMIN flush_table and compact_table over /v1/sql:
             K1 must launch in every window merge of 262,144 rows or more,
             and the card table's full scan must equal the reference's
             bit for bit. Over HTTP, each once cold and five times warm:
             Q1 and Q2 as SQL text, GROUP BY hostname and max by (region)
             (rate(cpu[1m])) on /v1/prometheus/api/v1/query_range; every
             request's launches are counted: each Q2 and PromQL request
             must launch K2, each GROUP BY G, Q2 and the GROUP BY must take
             the device path, and the PromQL fast path must serve each
             PromQL request. Every answer equals the reference's (exact;
             Q1's means within the reduction-order bound); Q2 and the
             PromQL query run once more under the profiler. Then
             Prometheus remote write: 20 metrics x 1,000 series (job,
             instance) x 40 samples at 15 s in snappy WriteRequests of
             2,000 samples (max_samples_per_send), sum by (job)
             (rate(m_0[1m])) through the fast path within the
             matrix-product bound of the reference's, and /read of m_0
             equal to the reference's. Last, close, reopen from the data
             root and Q1 over HTTP again. Printed: line-protocol rows/s
             over HTTP and of the parse alone (native and Python),
             remote-write samples/s, flush and compaction seconds, cold
             and warm walls and launches (cold, per warm request) per
             query, device ms and idle share of Q2 and the PromQL query,
             reopen ms. Kernel counts are zeroed before the phase and read
             after it; both data roots are removed.

13. flow   — flows (continuous aggregation): phase 2's TSBS devops rows
             (same seed; 4000 hosts at 10 s, ten usage_* fields), cut to
             the first --flow-hours 2 hours for the script's time limit
             (12 is phase 2's whole span), each hour's four 15-minute
             runs without the re-delivery and tombstone runs (a flow
             mirrors every insert, so a re-delivered row would count
             twice), written in deltas of 10,000 rows (tsbs_load's
             --batch-size; 288 deltas at 2 hours) through `_insert`'s
             columnar write and its flow delta into a Standalone on the card
             (engine-opened, WAL on, wal_sync at its default) with two
             flows created first: cpu_1h (avg and max of the ten fields BY
             hostname, date_bin('1 hour', ts): TSBS double-groupby-all and
             cpu-max-all kept as a rollup) and cpu_1h_stats (count, min,
             stddev_samp, first_value and last_value of usage_user), 4,000
             groups an hour each, ticked by hand at the end of every hour.
             Hard
             checks: every delta launches G, the same number of times; no
             flow is demoted and no apply or tick fails; after the first
             hour's tick both sinks and both device states equal, bit for
             bit, the port on the CPU fed the same deltas (run in a worker
             process while the card writes); after the last hour count,
             min, max, first_value and last_value equal numpy over the
             float32-cast rows, avg and stddev_samp within the bounds
             stated in flow_check_numpy; 20 line-protocol bodies of 10,000
             lines over HTTP into a fresh card Standalone give sinks and
             states equal bit for bit to the same rows through the
             columnar route in the same splits; cpu_1h_stats with
             x64=True over the first hour launches G's float64 sum and
             min forms and equals the CPU port in x64 mode bit for bit.
             Then G at the flow's shapes (one row block over the state's
             capacity) and G's float64 max/min form (the x64 leg's shape
             and edge inputs: NaN payloads of both signs, +-0.0, +-inf,
             ragged groups, one and eight row blocks) against their plain
             versions, bit for bit, timed beside their bounds, their plain
             versions and scatter_reduce. Printed: rows/s of the write
             with the flows on, host ms of each delta in on_insert, G
             calls a delta by form, the hourly ticks and the tick over all
             groups (finalize and readback, sink upsert), the state
             bytes, device ms and idle share of one warm delta under the
             profiler. Kernel counts are zeroed before the phase and read
             after its main path; the data roots are removed.

14. window — SQL window functions on bench.py's table: phase 2's TSBS
             devops rows (same seed), each hour's four 15-minute runs
             without the re-delivery and tombstone runs, so every host
             keeps its 4,320 rows, written anew and compacted on the card.
             bench.py's window metric, sum(usage_user) OVER (PARTITION BY
             hostname ORDER BY ts) over 61 hosts (263,520 rows at 12 h),
             and max and count over the same window, through
             Instance(device=card).sql, with x64 off (the compensated
             two-float scans and int32 counts) and on (float64 and int64
             scans): each cold, then warm (median of 7 for the metric,
             sql_window_running_sum_262k_ms, the sum without x64; of 3
             for the others) and once under the profiler, and the
             metric's scan alone (its query without the window). Both must take the device path, through kernel
             S. Then ROWS BETWEEN 5 PRECEDING AND CURRENT ROW sum and count
             with x64 over the process-wide mesh of 4 shards on the card,
             which must take the device_mesh path. Every answer equals the
             port on the CPU (Instance(device="cpu"), the same mesh) bit
             for bit. Then S alone, in each of its eight forms, against
             its plain version on the same inputs, bit for bit (the add
             forms hold NaN positions, C2), on edge inputs (NaN of both
             signs, +-0.0, +-inf, tied hi parts; a reset on every row, on
             row 0 only, every 7 rows and every 4,320) at sizes across its
             tile levels: its tile's edges (4,095, 4,096 and 4,097 rows),
             the resident form's edge (as many tiles as the card holds
             blocks of the form at once, and one more) and past one
             block's capacity of totals (4,096 x 4,097 + 5 rows); and at
             the full table's 17.28 M rows (a reset per host) and the
             metric's 263,520, timed there with CUDA events (median of
             20) and the profiler beside its bytes bound, its plain
             version and torch.cumsum over the same rows for scale. The
             profiler, whose count of kernel records is a floor in a long
             process, must see no more than one launch of S's kernel a
             scan, and S in what it sees of a warm metric query. S's count is zeroed before the phase's
             queries and read after them.

15. relational — joins, CTEs, subqueries, set operations and views
             through Standalone.sql on the card, over phase 14's table
             (handed over, not written again; 17.28 M rows compacted on
             the card through K1) and a tags table of one row a host
             (hostname, its region, a datacenter of that region, a rack
             and an os, drawn from --seed as TSBS devops draws them,
             cmd/tsbs_generate_data/devops/host.go in the TSBS sources),
             created by SQL DDL and INSERT in a card Standalone with the
             cpu table registered. The CPU port's answers come from phase
             16's reference worker (see there), sent ahead at the phase's
             start and compared after the card's queries. The first
             hour is ts < 3600000 (1.44 M rows). R1: a join, then GROUP BY
             datacenter over the 1.44 M-row frame (G on the card; counts
             against the tags table); R2: an uncorrelated IN over a device
             GROUP BY; R3: a RANGE 1h BY hostname on the grid inside a CTE
             (the CTE must take the grid's one-device program), joined and
             grouped by region and ts; R4: a correlated scalar subquery
             (decorrelated: one inner GROUP BY, then a lookup per outer
             row); R5: the first hour's hosts with max(usage_user) > 99
             EXCEPT, and once INTERSECT ALL, the hosts of one os; R6: a
             view (avg(usage_user) by host over the first hour) joined to
             the tags and grouped by region. Each query runs cold, warm
             (median of 3; the first warm call under query/stats'
             collector, for the join's host ms and rows) and once under
             the profiler (device ms, idle share), and equals the CPU
             port's answer bit for bit (names, row order, dtypes,
             values, validity), but for R3's max of the CTE's means:
             the grid sums an hour's 360 ten-second cells in torch's
             order, which differs between the card and the CPU (ROADMAP
             C2), so that column is held to 2 (w - 1) 2^-24 relative
             with w = 360 (compare_engines), its keys, order, dtypes and
             validity exactly. Every query must launch G; every one but
             R5 (whose last leaf is the tags scan) must end on the device
             path. Kernel counts are zeroed before the queries and read
             after them; the data roots are removed.

16. session — EXPLAIN and EXPLAIN ANALYZE, PREPARE/EXECUTE, ADMIN kill,
             information_schema and pg_catalog, and SET, through a card
             Standalone built as phase 15 builds its own (phase 14's table
             registered as cpu, the tags table and the view made by SQL).
             The CPU port's answers come from a worker process that builds
             phase 14's table anew on the CPU from the same seed (while
             phase 14 runs), with the same tags table and view, and
             answers phase 15's queries and then this phase's statements,
             sent ahead in order, while the card works. EXPLAIN of Q2 (count/sum/min/max/avg/
             stddev_samp/first/last of usage_user RANGE 2h ALIGN 1h BY
             region, on the grid through K2), of a GROUP BY hostname over
             the first hour (G), of R1 (G) and of the window metric's
             query (S): the plan lines equal the CPU port's. Each query
             runs cold, then the plain query and its EXPLAIN ANALYZE in
             turns, three times each, the order swapped every turn (the
             collector's overhead: warm median beside warm median). The
             first EXPLAIN ANALYZE is held against the CPU port's: the
             plan lines and the row
             count equal the plain query's and the CPU port's, every note
             and count equals the CPU port's (times only present), the
             path is the device's (exec_path_range, _aggregate or
             _window) and its kernel launches. PREPARE g AS a GROUP BY
             hostname over $1 <= ts < $2, EXECUTE'd for the first and the
             second hour: each answer equals the literal query and the
             CPU port's bit for bit, G launches, and EXECUTE and the
             literal query run in turns three times each, the order
             swapped every turn; DEALLOCATE, then EXECUTE must raise the
             JAX package's error. ADMIN kill: the victim, a UNION ALL of
             the --hours hourly GROUP BYs (a scan and so a cancellation
             checkpoint a leaf), runs on a thread of its own; the main
             thread reads SHOW PROCESSLIST until it shows the victim
             Running, then ADMIN kill('<id>') must answer 1 and the victim
             raise "query <id> was killed" (the time from the kill to the
             raise is printed beside one leaf's warm wall); then the
             victim runs whole, equal to the CPU port's answer, and once
             more, warm. information_schema tables, columns and
             key_column_usage of cpu and tags, the tables-columns join and
             psql's \\dt (pg_class JOIN pg_namespace) equal the CPU port's
             answers, and over /v1/sql (HttpServer on the card Standalone)
             the in-process answer; each is timed warm (median of 3).
             SET time_zone and read_preference round-trip through SHOW
             VARIABLES on one session. Kernel counts are zeroed before
             the phase and read after it; the data roots are removed.

17. poll   — the dashboard poll path on phase 14's table (17.28 M rows,
             not cut), in one card Standalone with query sessions on and
             the result cache enabled as the JAX package's tests enable
             it. P1 is Q2's SQL text (RANGE 2h ALIGN 1h BY region, through
             K2), P2 the per-host panel avg(usage_user) RANGE '1m' ALIGN
             '1m' BY (hostname) (4,000 hosts x 720 cells). For each: a
             cold poll (the grid's build), three warm polls with sessions
             off (the program on the cached grid), three session hits
             (no range program and no K2 may run), three result-cache
             hits (no kernel may launch, no byte may be read back), and,
             cache off, a full poll beside a `since` poll whose cursor is
             the step before the last: it must read back exactly one
             step's bytes (the full poll's over the step count) and answer
             the full result's rows past the cursor. Then the aliasing
             check: another RANGE query through K2, then P1 again, a
             session hit bit for bit equal to P1's first answer. Then an
             INSERT of the next minute of usage_user for all 4,000 hosts:
             the next poll of each must miss both caches and run the
             program again (K2 for P1), and equal the CPU port's answer
             over the same rows (the reference worker of phase 16, fed
             the same INSERT): P1 bit for bit, P2 within C2's
             reorder bound over its six-cell windows; a `since` poll at
             the old last step answers exactly the new steps. Admission
             over /v1/sql with basic auth (two users) under
             max_concurrency 2: with both slots held, eight client
             threads polling P1 must all show "Queued" in SHOW PROCESSLIST
             and then answer the single client's answer; timeout=0.5 on
             phase 16's 12-leaf UNION ALL (every leaf warm) answers 503
             within the largest leaf's warm wall (+ 0.1 s) of its
             deadline; a tenant at 1 qps answers 200 then 429 while the
             other completes; a wrong password answers 401. Printed per
             poll: walls, launches, range programs and readback bytes.
             Kernel counts are zeroed before the phase and read after it;
             the data root is removed.

18. index  — the secondary tag index, its card-resident label plane and
             fulltext, with the json, geo and net functions.
             a. Phase 7's prom_bench table (1 M series, no new ingest) and
                its one-device and ring engines: sum by (dc) (rate(...))
                and topk(5, ...) over {dc="dc3"}, {dc=~"dc(1|2)"},
                {host=~"host_1.*"} and {dc!="dc0", host!~"host_9.*"}
                (phase 7's dc labels are dc0..dc31), each cold and warm
                (median of 3), with the label plane on (the mask is a
                gather and AND over the resident (S_pad, 2) code matrix;
                only the ok-tables move) and off
                (`tag_index.configure({"device_plane": False})`: the host
                mask through the index, uploaded). The set's first query
                must take the plane with it on and the host mask with it
                off; a repeated query must upload nothing. Plane and host
                masks answer bit for bit; the ring equals one device as in
                phase 7; one device equals the port on the CPU (topk
                exactly, the aggregate within phase 7's matrix-product
                bound), which a worker process started after phase 7
                runs over the same rows written anew. Then per set and engine: the ok-table bytes beside
                the S_pad bytes, the plane's gather and AND (CUDA events,
                median of 20), the host mask's upload, and on one device
                the host ms of each whole path (the regex over the
                distinct values runs in both); the plane's mask must equal
                the host's and its repeat be a cache hit that uploads
                nothing. The plane's build ms and bytes are printed.
             b. bench.py's index probe (bench.py:4333-4357): 1.2 M series
                holding a host tag of 2,000 and one of 20,000 values (one
                registry, host code only, in the same worker):
                TagIndex.match_sids of v17(00)? equals the registry's
                linear match, timed beside it; and 12 SSTs of
                500 fresh hosts x 12 points in a card Standalone, where a
                host = '...' SELECT and GROUP BY must note scan_path
                index_pruned with index_pruned_bytes > 0 in EXPLAIN
                ANALYZE and answer the same rows with the index off.
             c. An append-mode access log with a FULLTEXT message column:
                4 flushes of 270,000 lines shaped like Apache's common log
                format (16 web servers, a line every 10 ms, from --seed),
                so 4 SSTs of two row groups at the default 262,144 rows;
                only the third holds "/wp_login.php", on its first row
                group. count(*) of matches(message, ...) for that term (3
                SSTs and 1 row group pruned), an absent term (4 SSTs), an
                OR (nothing pruned) and a phrase (as the term), then
                json_get_*, json_path_exists, json_is_object, st_distance,
                geohash, h3_latlng_to_cell, st_point and the ipv4
                functions over the first 1,000 lines; every answer equals
                the port on the CPU (the worker, over the same rows
                written anew) with the sidecars removed (which must prune
                nothing).
             Kernel counts are zeroed before the phase and read after its
             queries; the data roots are removed.

Output: one JSON line per phase, the nvidia-smi line, a line with the
phases that ran and the script's seconds, a {"kernels": [...]} line, and
last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

FIELDS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice",
    "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
    "usage_guest", "usage_guest_nice",
]
AWS_REGIONS = [
    "us-east-1", "us-west-1", "us-west-2", "eu-west-1", "eu-central-1",
    "ap-southeast-1", "ap-southeast-2", "ap-northeast-1", "sa-east-1",
]
STEP_MS = 10_000
HOUR_MS = 3_600_000
Q2_OPS = ["count", "sum", "min", "max", "mean", "stddev_samp",
          "first_value", "last_value"]
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# and float64 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12   # float64 outside the tensor cores
U = 2.0 ** -24
# warm SQL Q2 runs per ring form in the sql phase's interleaved timing
Q2_WALL_REPS = 30


def _device() -> torch.device:
    return torch.device("cuda")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warm=3) -> float:
    """Median of `reps` single-launch CUDA-event timings after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps=20, warm=3) -> float:
    """Median host time of one call (its return, not its kernels': the
    card is synchronized after each call, outside the timing)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def profiled(fn, top=4):
    """One call of fn under torch.profiler: wall ms, summed device ms of
    kernels, copies and sets (None when the profiler saw no device
    activity), the copies' and sets' share of it (`copy_ms`), the device's
    idle share of the wall time, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpys, memsets): a CPU op's
        # device time repeats the time of the kernels it launched
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith("Activity Buffer")):
            continue
        us = evt.self_device_time_total
        if us:
            rows.append((us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) if rows else None
    copy_ms = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    # the port's own kernels (csrc/*.cu keep them in an anonymous
    # namespace; torch's there name at:: types), by name with template
    # arguments
    ours = {}
    for ms, k, c in rows:
        k = k.removeprefix("void ")
        name = k.split("::", 1)[-1].split("(")[0]
        if k.startswith("(anonymous namespace)::") and "at::" not in name:
            ours[name] = {"ms": ms, "calls": c}
    return {
        "wall_ms": wall, "device_ms": dev_ms, "copy_ms": copy_ms,
        "idle_share": None if dev_ms is None else 1.0 - dev_ms / wall,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                for ms, k, c in rows[:top]],
        "ours": ours,
    }


def device_ms_per_launch(prof, match) -> float | None:
    """Profiler device time per launch of the port's kernels whose names
    satisfy `match` (None when the profile saw none)."""
    hits = [v for k, v in prof.get("ours", {}).items() if match(k)]
    calls = sum(v["calls"] for v in hits)
    return sum(v["ms"] for v in hits) / calls if calls else None


def make_plans(P):
    q1 = P.SelectPlan(
        kind="range",
        keys=[P.KeySpec("__key_0", P.Column("hostname"), "hostname")],
        range_items=[P.RangeItemSpec(f"__r_{i}", "mean", P.Column(f),
                                     HOUR_MS) for i, f in enumerate(FIELDS)],
        post_items=[(P.Column("__ts"), "ts"),
                    (P.Column("__key_0"), "hostname")]
        + [(P.Column(f"__r_{i}"), f"avg({f})") for i, f in enumerate(FIELDS)],
        align_ms=HOUR_MS, ts_out_name="__ts",
    )
    q2 = P.SelectPlan(
        kind="range",
        keys=[P.KeySpec("__key_0", P.Column("region"), "region")],
        range_items=[P.RangeItemSpec(f"__r_{i}", op, P.Column("usage_user"),
                                     2 * HOUR_MS)
                     for i, op in enumerate(Q2_OPS)],
        post_items=[(P.Column("__ts"), "ts"), (P.Column("__key_0"), "region")]
        + [(P.Column(f"__r_{i}"), f"{op}(usage_user)")
           for i, op in enumerate(Q2_OPS)],
        align_ms=HOUR_MS, ts_out_name="__ts",
    )
    return q1, q2


def tsbs_hours(rng, hosts, region_of, hours):
    """The TSBS runs, hour by hour: per hour the four 15-minute runs, then
    a late re-delivery of 10% of the hour's keys, then 1% tombstones, as
    ("put" | "delete", tags, ts, fields) in write order."""
    per_hour = HOUR_MS // STEP_MS
    per_run = per_hour // 4
    n_hosts = len(hosts)
    for h in range(hours):
        runs = []
        for r in range(4):
            t0 = h * per_hour + r * per_run
            ts = np.tile(np.arange(t0, t0 + per_run, dtype=np.int64)
                         * STEP_MS, n_hosts)
            hi = np.repeat(np.arange(n_hosts), per_run)
            fields = {f: (rng.random(len(ts), dtype=np.float32)
                          * 100.0).astype(np.float64) for f in FIELDS}
            runs.append(("put", {"hostname": hosts[hi],
                                 "region": region_of[hi]}, ts, fields))
        ts_h = np.tile(np.arange(h * per_hour, (h + 1) * per_hour,
                                 dtype=np.int64) * STEP_MS, n_hosts)
        hi_h = np.repeat(np.arange(n_hosts), per_hour)
        re = rng.random(len(ts_h)) < 0.10
        runs.append(("put", {"hostname": hosts[hi_h[re]],
                             "region": region_of[hi_h[re]]}, ts_h[re],
                     {f: (rng.random(int(re.sum()), dtype=np.float32)
                          * 100.0).astype(np.float64) for f in FIELDS}))
        dl = rng.random(len(ts_h)) < 0.01
        runs.append(("delete", {"hostname": hosts[hi_h[dl]],
                                "region": region_of[hi_h[dl]]}, ts_h[dl],
                     None))
        yield runs


def write_run(table, run):
    kind, tags, ts, fields = run
    if kind == "delete":
        return table.delete(tags, ts)
    return table.write(tags, ts, fields)


def ingest(table, rng, hosts, region_of, hours):
    """Write the TSBS runs; returns rows written."""
    written = 0
    for runs in tsbs_hours(rng, hosts, region_of, hours):
        for run in runs:
            written += write_run(table, run)
    return written


def compare_results(name, gpu, cpu, exact_ops, w):
    """GPU result vs the port's CPU result: exact for `exact_ops` columns,
    keys and ts; other float columns within the reduction-order bound
    2 * (w - 1) * 2^-24 (relative, values >= 0). Returns max |diff|."""
    if gpu.names != cpu.names or gpu.num_rows != cpu.num_rows:
        raise AssertionError(f"{name}: shape {gpu.names}/{gpu.num_rows} "
                             f"vs {cpu.names}/{cpu.num_rows}")
    worst = 0.0
    for i, col in enumerate(gpu.names):
        a, b = gpu.cols[i], cpu.cols[i]
        if not np.array_equal(a.valid_mask, b.valid_mask):
            raise AssertionError(f"{name}: presence of {col}")
        av, bv = np.asarray(a.values), np.asarray(b.values)
        if av.dtype == object or col == "ts":
            if not np.array_equal(av, bv):
                raise AssertionError(f"{name}: column {col}")
            continue
        m = a.valid_mask
        diff = np.abs(av[m] - bv[m])
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
        if col.split("(")[0] in exact_ops:
            if not np.array_equal(av[m], bv[m]):
                raise AssertionError(f"{name}: {col} not bit-equal")
        elif not np.all(diff <= 2 * (w - 1) * U * np.abs(bv[m])):
            raise AssertionError(f"{name}: {col} past the bound")
    return worst


def check_q1_against_numpy(table, res, hosts):
    rows = table.scan(FIELDS).rows
    reg = table.region.series
    n_s = reg.num_series
    hours = int(rows.ts.max() // HOUR_MS) + 1
    key = rows.sid.astype(np.int64) * hours + rows.ts // HOUR_MS
    cnt = np.bincount(key, minlength=n_s * hours)
    host_sid = {h: i for i, h in enumerate(reg.tag_values("hostname"))}
    r_sid = np.array([host_sid[h] for h in res.column("hostname").values])
    r_key = r_sid * hours + res.column("ts").values // HOUR_MS
    worst = 0.0
    for f in FIELDS:
        mean = np.bincount(key, weights=rows.fields[f],
                           minlength=n_s * hours) / np.maximum(cnt, 1)
        got = res.column(f"avg({f})").values
        want = mean[r_key]
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(f"Q1 {f} differs from numpy hourly means")
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
    return worst


def window_rows(table, window):
    """The memtable runs of one compaction window, concatenated."""
    from greptimedb_tpu_torch.storage.memtable import _concat_rows

    return _concat_rows(table.region.memtable.partitions()[window],
                        table.field_names)


def k1_inputs(rows0, dev):
    """K1's main-path inputs for one window: the fused merge program's
    source indices and the (26, 2^21) plane matrix of the window's rows."""
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.storage import device_merge as dm

    n = len(rows0)
    up, valids, pad = dm._prep_uploads(rows0, backfill=False, device=dev)
    n_keep_d, src_keep, _ = dm._merge_program(up, n, valids,
                                              drop_deletes=True, fused=True)
    n_out = dm._pad_to_bucket(int(n_keep_d))
    cols = [rows0.sid, rows0.ts, rows0.seq, rows0.op]
    cols += [rows0.fields[f] for f in FIELDS]
    big = np.concatenate([mg.pack_planes(np.asarray(c)) for c in cols])
    big = np.concatenate(
        [big, np.zeros((big.shape[0], pad - n), np.uint32)], axis=1)
    planes = torch.from_numpy(big.view(np.int32)).to(dev)
    return planes, src_keep[:n_out].contiguous()


def kernel_checks(dev, planes, src, entry, memo, launches, add_ns):
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    out = []
    # ---- K1 -------------------------------------------------------------
    p, n = planes.shape
    n_out = src.shape[0]
    got = mg.gather_planes(planes, src)
    want = mg.gather_planes_plain(planes, src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 gather_planes differs from its plain version")
    # planes are bit patterns: the error is the largest difference of the
    # 32-bit words
    k1_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    k1_bytes = 4 * n_out * (1 + 2 * p)
    src64 = src.to(torch.int64)
    out.append({
        "name": "gather_planes", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/merge_gather.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/merge_gather.py:104",
        "launches": launches["gather_planes"],
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: mg.gather_planes(planes, src)),
        "host_ms": host_ms(lambda: mg.gather_planes(planes, src)),
        "plain_ms": cuda_ms(lambda: mg.gather_planes_plain(planes, src)),
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.index_select(planes, 1, src64)),
        "shape": {"P": p, "n": n, "n_out": n_out}, "bytes": k1_bytes,
    })
    # ---- K2 -------------------------------------------------------------
    # one device: every per-shard list of the entry holds one tensor
    fm = memo["fold_members"][0]
    out.append({
        "name": "blocked_fold_sum", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/ring_fold.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:34 "
                    "(_fold_seed_kernel) with "
                    "greptimedb_tpu/query/device_range.py:1509",
        "launches": launches["blocked_fold_sum"],
        **k2_measure(dev, rf, entry.fields["usage_user"]["s"][0],
                     entry.nrow[0], fm, add_ns),
    })
    return out


def add_chain_ns(dev, n=1 << 20) -> float:
    """The card's dependent-add latency: the fastest of three launches of
    one thread's chain of n adds (ring_fold.add_chain), over n."""
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = rf.add_chain(dev, n)
        b.record()
        b.synchronize()
        if float(out) != n:
            raise AssertionError(f"add_chain summed {float(out)}, not {n}")
        best = min(best, a.elapsed_time(b))
    return best * 1e6 / n


def k2_bound(fm, nb, add_ns):
    """K2's least time on this card for (S, nb) states over `fm`: the
    largest of the bytes (every input read once, the output written once)
    over HBM's rate, the adds over float32's peak, and the chain (the
    longest (block, group) list plus the fb - 1 fold adds, one dependent
    add each, at the card's `add_ns` a dependent add: add_chain_ns)."""
    m = fm.member.numel()
    counts = fm.ptr[1:] - fm.ptr[:-1]
    longest = int(counts.max()) if counts.numel() else 0
    nbytes = 4 * m * nb + 4 * fm.g * nb + 4 * m + 4 * fm.ptr.numel()
    parts = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": m * nb / F32_OPS_PER_S * 1e3,
        "chain": (longest + fm.fb - 1) * add_ns * 1e-6,
    }
    by = max(parts, key=parts.get)
    return {"bound_ms": parts[by], "bound_by": by,
            "bound_parts_ms": parts, "bytes": nbytes,
            "longest_list": longest, "add_ns": add_ns}


def k2_measure(dev, rf, arr_f, arr_i, fm, add_ns, plain_reps=20):
    """K2 at one shape: float32 (arr_f) and int32 (arr_i) held bit for bit
    against the plain version on the same inputs, then timed: events ms,
    host ms and profiler device ms a launch, beside the plain version,
    index_add_ into g + 1 rows (unlisted series in the last) and the
    bound."""
    err = 0.0
    for arr in (arr_f, arr_i):
        got = rf.blocked_fold_sum(arr, fm)
        want = rf.blocked_fold_sum_plain(arr, fm)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(
                f"K2 blocked_fold_sum ({arr.dtype}, {tuple(arr.shape)}) "
                f"differs from its plain version")
        err = max(err, float(torch.nan_to_num(
            (got.double() - want.double()).abs(), nan=0.0).max()))
    s, nb = arr_f.shape
    gid64 = torch.full((s,), fm.g, dtype=torch.int64, device=dev)
    grp = torch.repeat_interleave(
        torch.arange(fm.fb * fm.g, device=dev) % fm.g,
        (fm.ptr[1:] - fm.ptr[:-1]).long())
    gid64[fm.member.long()] = grp

    def library():
        acc = torch.zeros((fm.g + 1, nb), dtype=arr_f.dtype, device=dev)
        return acc.index_add_(0, gid64, arr_f)

    # a profile that saw no device activity (it happens after many
    # profiles in one process) is taken once more; burst_ms times the
    # same launches with events
    dev_ms = None
    for _ in range(2):
        prof = profiled(lambda: [rf.blocked_fold_sum(arr_f, fm)
                                 for _ in range(10)], top=3)
        dev_ms = device_ms_per_launch(prof, is_seed_kernel)
        if dev_ms is not None:
            break
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.blocked_fold_sum(arr_f, fm)),
        "host_ms": host_ms(lambda: rf.blocked_fold_sum(arr_f, fm)),
        "device_ms_per_launch": dev_ms,
        "burst_ms": burst_ms(lambda: rf.blocked_fold_sum(arr_f, fm)),
        "plain_ms": cuda_ms(lambda: rf.blocked_fold_sum_plain(arr_f, fm),
                            reps=plain_reps, warm=1),
        **k2_bound(fm, nb, add_ns),
        "library_ms": cuda_ms(library),
        "ms_int32": cuda_ms(lambda: rf.blocked_fold_sum(arr_i, fm)),
        "form": rf.blocked_fold_form(fm.g, nb, fm.member.numel()),
        "shape": {"S": s, "nb": nb, "g": fm.g, "fb": fm.fb,
                  "members": fm.member.numel()},
    }


RING_KERNELS = ("fold_cont", "extreme", "onehot_add", "ring_fold_fused",
                "ring_pext_fused", "ring_psum_onehot_fused")
# the hop ring's combines: phase 8's fused=False engine runs them
HOP_KERNELS = ("blocked_fold_sum", "fold_cont", "extreme", "onehot_add")
# the one-launch ring forms, on shards that share a card
ONE_RING_KERNELS = ("ring_fold_fused", "ring_pext_fused",
                    "ring_psum_onehot_fused")
# per warm mesh Q2 on four shards: 10 ring extremes and 4 ring one-hot
# sums (3 hops each on the hop ring)
Q2_RINGS = {"ring_pext_fused": 10, "ring_psum_onehot_fused": 4,
            "ring_fold_fused": 12}
Q2_HOPS = {"extreme": 30, "onehot_add": 12}
# per warm mesh Q2 on four shards: the hop ring's 12 folds (a seed and
# three fold_cont each), the gather twin's (block_partials on each shard)
Q2_HOP_FOLDS = {"blocked_fold_sum": 12, "fold_cont": 36}
Q2_GATHER_FOLDS = {"block_partials": 48}
FOLD_KERNELS = ("blocked_fold_sum", "block_partials") + RING_KERNELS
# the topk ring's kernels: the merge hop and the ring in one launch
TOPK_KERNELS = ("merge_candidates", "ring_topk_merge_fused")


def counts(rf, mg):
    """Launch counts of every kernel wrapper."""
    return {"gather_planes": mg.gather_planes.launches,
            **{f: getattr(rf, f).launches for f in FOLD_KERNELS}}


def zero_counts(rf, mg):
    mg.gather_planes.launches = 0
    for f in FOLD_KERNELS:
        getattr(rf, f).launches = 0


@contextlib.contextmanager
def ring_form(form):
    """Run the ring engines' rings as `form`: "fused" is the devices' own
    choice for shards on one card (one launch a ring); "hops" is
    RingFoldCtx(ns, fused=False) (K2's seed, then fold_cont hop by hop)
    and ring_topk_merge_hops (merge_candidates hop by hop), which the
    query paths take while this block is open."""
    if form != "hops":
        yield
        return
    from greptimedb_tpu_torch.parallel.kernels import ring_fold
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm

    real, real_topk = ring_fold.RingFoldCtx, tm.ring_topk_merge
    ring_fold.RingFoldCtx = functools.partial(real, fused=False)
    tm.ring_topk_merge = tm.ring_topk_merge_hops
    try:
        yield
    finally:
        ring_fold.RingFoldCtx, tm.ring_topk_merge = real, real_topk


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64) if v.dtype == np.float64 else v


def same_column(a, b) -> bool:
    """Values bit for bit (NaN equal to NaN) and presence."""
    va, vb = np.asarray(a.values), np.asarray(b.values)
    if not np.array_equal(a.valid_mask, b.valid_mask) or va.shape != vb.shape:
        return False
    if va.dtype == object:
        return bool((va == vb).all())
    return bool(np.array_equal(_bits(va), _bits(vb)))


def compare_engines(name, ref, got, w, bounded=(), names=True):
    """`got` against `ref` column by column: bit-identical, except the
    columns named in `bounded` (Q1's disjoint-window means), whose keys,
    presence and timestamps must still be identical and whose values stay
    within 2 (w - 1) 2^-24 relative. names=False compares columns by
    position (a SQL result against a plan-built one). Returns (identical,
    max rel diff)."""
    if ((names and got.names != ref.names)
            or len(got.names) != len(ref.names)
            or got.num_rows != ref.num_rows):
        raise AssertionError(f"{name}: shape {got.names}/{got.num_rows} vs "
                             f"{ref.names}/{ref.num_rows}")
    identical, worst = True, 0.0
    for col, a, b in zip(ref.names, ref.cols, got.cols):
        if same_column(a, b):
            continue
        if col not in bounded or not np.array_equal(a.valid_mask,
                                                     b.valid_mask):
            raise AssertionError(f"{name}: column {col} differs")
        identical = False
        m = a.valid_mask
        av, bv = np.asarray(a.values)[m], np.asarray(b.values)[m]
        rel = np.abs(av - bv) / np.abs(av)
        worst = max(worst, float(rel.max()))
        if not np.all(np.abs(av - bv) <= 2 * (w - 1) * U * np.abs(av)):
            raise AssertionError(f"{name}: {col} past the bound")
    return identical, worst


def mesh_kernel_rows(dev, entry, memo, launches):
    """The ring kernels and K2's partials form at the shapes the sharded
    Q2 gave them (shards 0 and 1 of the ring engine's grid), held against
    their plain versions and timed."""
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import device_range as dr

    fms, gids, g = memo["fold_members"], memo["gid"], memo["g"]
    st = entry.fields["usage_user"]
    nb = entry.nb
    plane = g * nb

    def exact(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} differs from its plain version")
        return float((got.double() - want.double()).abs().max())

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    src = "greptimedb_tpu_torch/parallel/kernels/csrc/ring_fold.cu"
    walk_src = ("greptimedb_tpu_torch/parallel/kernels/csrc/"
                "ring_fold_fused.cu")
    rows = []
    # ---- row 3: K2's continuation, shard 1 onto shard 0's seed ----------
    fm = fms[1]
    m = fm.member.numel()
    err = 0.0
    for arr0, arr1 in ((st["s"][0], st["s"][1]), (entry.nrow[0],
                                                  entry.nrow[1])):
        acc = rf.blocked_fold_sum(arr0, fms[0])
        err = max(err, exact("fold_cont", rf.fold_cont(acc, arr1, fm),
                             rf.fold_cont_plain(acc, arr1, fm)))
    # the walk's two single-shard forms on edge bits, on rows one element
    # past a 16-byte boundary (the 4-byte copies) and on an odd cell count
    rng = np.random.default_rng(29)
    s_local = st["s"][1].shape[0]
    for width, off in ((nb, 0), (nb, 1), (nb + 1, 1)):
        flat = torch.from_numpy(ring_edge_input(
            rng, s_local + 1, width, "f32")).to(dev).reshape(-1)
        x = flat[off:off + s_local * width].view(s_local, width)
        a0 = torch.from_numpy(ring_edge_input(rng, g, width, "f32")).to(dev)
        a0[:, ::7] = -0.0
        what = f"({width} cells, {'misaligned' if off else 'aligned'})"
        exact(f"fold_cont {what}", rf.fold_cont(a0, x, fm),
              rf.fold_cont_plain(a0, x, fm))
        exact(f"block_partials {what}", rf.block_partials(x, fm),
              rf.block_partials_plain(x, fm))
    acc = rf.blocked_fold_sum(st["s"][0], fms[0])
    acc_i = rf.blocked_fold_sum(entry.nrow[0], fms[0])
    arr1 = st["s"][1]
    gid64 = gids[1].clamp(max=g).to(torch.int64)

    def index_add():
        return torch.zeros((g + 1, nb), dtype=torch.float32,
                           device=dev).index_add_(0, gid64, arr1)

    cont_bytes = 4 * m * nb + 2 * 4 * plane
    rows.append({
        "name": "fold_cont", "route": "cuda", "source": walk_src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:44 "
                    "(_fold_cont_kernel, through _call2:84)",
        "launches": launches["fold_cont"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.fold_cont(acc, arr1, fm)),
        "host_ms": host_ms(lambda: rf.fold_cont(acc, arr1, fm)),
        "plain_ms": cuda_ms(lambda: rf.fold_cont_plain(acc, arr1, fm)),
        **bound(cont_bytes, m * nb + fm.fb * plane),
        "library_ms": cuda_ms(index_add),
        "ms_int32": cuda_ms(lambda: rf.fold_cont(acc_i, entry.nrow[1], fm)),
        "shape": {"s_local": arr1.shape[0], "nb": nb, "g": g,
                  "fb_local": fm.fb, "members": m},
        "bytes": cont_bytes, "design": walk_design(rf, "fold_cont"),
    })
    # ---- rows 4 and 5: the hop form on shards 0 and 1, the one-launch
    # ring form over all ns shards: the extreme, f32 (the m plane) and
    # int32 (win_t), and the one-hot add (first/last winner values) ------
    ns = len(fms)
    xs = {tm: [dr._segment_ext(st["mx" if tm else "mn"][k], gids[k], g, tm)
               for k in range(ns)] for tm in (True, False)}
    ts = [dr._segment_ext(st["il"][k], gids[k], g, True) for k in range(ns)]
    err = 0.0
    for tm in (True, False):
        a, b = xs[tm][:2]
        err = max(err, exact("extreme", rf.extreme(a, b, tm),
                             rf.extreme_plain(a, b, tm)))
    exact("extreme int32", rf.extreme(ts[0], ts[1], True),
          rf.extreme_plain(ts[0], ts[1], True))
    ring_err = 0.0
    for planes in (xs[True], xs[False], ts):
        for tm in (True, False):
            got = rf.ring_pext_fused(planes, tm)[0]
            want = rf.ring_pext_fused_plain(planes, tm)[0]
            ring_err = max(ring_err, exact("ring_pext_fused", got, want))
            exact("ring_pext_fused against the hop ring", got,
                  rf.ring_pext(planes, tm)[0])
    win_t = rf.ring_pext_fused(ts, True)[0]
    has = [st["n"][k] > 0 for k in range(ns)]
    oh = [dr._segment_sum_onehot(torch.where(
        has[k] & (st["il"][k] == win_t[gids[k].clamp(max=g - 1).long()]),
        st["vl"][k], 0.0), gids[k], g) for k in range(ns)]
    floor = {"launch_floor_ms": cuda_ms(lambda: rf.noop(dev)),
             "launch_floor_host_ms": host_ms(lambda: rf.noop(dev))}
    pext4 = xs[True]
    a, b = pext4[:2]

    def max_chain():
        acc = pext4[0]
        for x in pext4[1:]:
            acc = torch.maximum(acc, x)
        return acc

    pext_ring = {
        "ring_ms": cuda_ms(lambda: rf.ring_pext_fused(pext4, True)),
        "ring_host_ms": host_ms(lambda: rf.ring_pext_fused(pext4, True)),
        "ring_plain_ms": cuda_ms(
            lambda: rf.ring_pext_fused_plain(pext4, True)),
        "ring_bound_ms": 4 * (ns + 1) * plane / HBM_BYTES_PER_S * 1e3,
        "library_chain_ms": cuda_ms(max_chain),
        "ring_ms_int32": cuda_ms(lambda: rf.ring_pext_fused(ts, True)),
    }
    rows.append({
        "name": "extreme", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:53 "
                    "(_ext_max_kernel) and :59 (_ext_min_kernel), through "
                    "_call2:84",
        "launches": launches["extreme"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.extreme(a, b, True)),
        "host_ms": host_ms(lambda: rf.extreme(a, b, True)),
        "plain_ms": cuda_ms(lambda: rf.extreme_plain(a, b, True)),
        **bound(3 * 4 * plane, plane),
        "library_ms": cuda_ms(lambda: torch.maximum(a, b)),
        "ms_int32": cuda_ms(lambda: rf.extreme(ts[0], ts[1], True)),
        **pext_ring, **floor,
        "shape": {"g": g, "nb": nb, "ring_shards": ns},
    })
    rows.append({
        "name": "ring_pext_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:109 "
                    "ring_pext (the chain of _ext_max_kernel:53 or "
                    "_ext_min_kernel:59 through _call2:80, hop by hop)",
        "launches": launches["ring_pext_fused"], "max_abs_err": ring_err,
        "ms": pext_ring["ring_ms"], "host_ms": pext_ring["ring_host_ms"],
        "plain_ms": pext_ring["ring_plain_ms"],
        **bound(4 * (ns + 1) * plane, (ns - 1) * plane),
        "library_ms": pext_ring["library_chain_ms"],
        "ms_int32": pext_ring["ring_ms_int32"], **floor,
        "shape": {"shards": ns, "g": g, "nb": nb},
    })

    def add_chain():
        acc = oh[0]
        for x in oh[1:]:
            acc = torch.add(acc, x)
        return acc

    err = exact("onehot_add", rf.onehot_add(oh[0], oh[1]),
                rf.onehot_add_plain(oh[0], oh[1]))
    got = rf.ring_psum_onehot_fused(oh)[0]
    ring_err = exact("ring_psum_onehot_fused", got,
                     rf.ring_psum_onehot_fused_plain(oh)[0])
    exact("ring_psum_onehot_fused against the hop ring", got,
          rf.ring_psum_onehot(oh)[0])
    psum_ring = {
        "ring_ms": cuda_ms(lambda: rf.ring_psum_onehot_fused(oh)),
        "ring_host_ms": host_ms(lambda: rf.ring_psum_onehot_fused(oh)),
        "ring_plain_ms": cuda_ms(
            lambda: rf.ring_psum_onehot_fused_plain(oh)),
        "ring_bound_ms": 4 * (ns + 1) * plane / HBM_BYTES_PER_S * 1e3,
        "library_chain_ms": cuda_ms(add_chain),
    }
    rows.append({
        "name": "onehot_add", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:65 "
                    "(_add_kernel, through _call2:84)",
        "launches": launches["onehot_add"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.onehot_add(oh[0], oh[1])),
        "host_ms": host_ms(lambda: rf.onehot_add(oh[0], oh[1])),
        "plain_ms": cuda_ms(lambda: rf.onehot_add_plain(oh[0], oh[1])),
        **bound(3 * 4 * plane, plane),
        "library_ms": cuda_ms(lambda: torch.add(oh[0], oh[1])),
        **psum_ring, **floor,
        "shape": {"g": g, "nb": nb, "ring_shards": ns},
    })
    rows.append({
        "name": "ring_psum_onehot_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:122 "
                    "ring_psum_onehot (the chain of _add_kernel:65 through "
                    "_call2:80, hop by hop)",
        "launches": launches["ring_psum_onehot_fused"],
        "max_abs_err": ring_err,
        "ms": psum_ring["ring_ms"], "host_ms": psum_ring["ring_host_ms"],
        "plain_ms": psum_ring["ring_plain_ms"],
        **bound(4 * (ns + 1) * plane, (ns - 1) * plane),
        "library_ms": psum_ring["library_chain_ms"], **floor,
        "shape": {"shards": ns, "g": g, "nb": nb},
    })
    # ---- K2's partials form (the gather twin's block partials) ----------
    err = exact("block_partials", rf.block_partials(arr1, fm),
                rf.block_partials_plain(arr1, fm))
    per = fm.s // fm.fb
    bid = torch.arange(fm.s, device=dev) // per
    seg = torch.where(gids[1] < g, bid * g + gids[1], fm.fb * g).long()
    partials_bytes = 4 * m * nb + 4 * fm.fb * plane
    rows.append({
        "name": "block_partials", "route": "cuda", "source": walk_src,
        "replaces": "greptimedb_tpu/query/device_range.py:1509 (blocked_sum"
                    "'s per-block segment_sum, which the gather program "
                    "concatenates across shards)",
        "launches": launches["block_partials"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.block_partials(arr1, fm)),
        "host_ms": host_ms(lambda: rf.block_partials(arr1, fm)),
        "plain_ms": cuda_ms(lambda: rf.block_partials_plain(arr1, fm)),
        **bound(partials_bytes, m * nb),
        "library_ms": cuda_ms(lambda: torch.zeros(
            (fm.fb * g + 1, nb), device=dev).index_add_(0, seg, arr1)),
        "shape": {"s_local": arr1.shape[0], "nb": nb, "g": g,
                  "fb_local": fm.fb, "members": m},
        "bytes": partials_bytes, "design": walk_design(rf, "block_partials"),
    })
    # ---- row 6: the fused ring over every shard, one launch a fold ------
    s_f, s_i = list(st["s"]), list(entry.nrow)
    err = 0.0
    for arrs in (s_f, s_i):
        got, want = rf.ring_fold_fused(arrs, fms), rf.ring_fold_fused_plain(
            arrs, fms)
        hops = rf.ring_fold_blocks(arrs, fms)
        for k in range(ns):
            err = max(err, exact("ring_fold_fused", got[k], want[k]))
            exact("ring_fold_fused against the hop ring", got[k], hops[k])
    # edge bits at the path's shapes and member lists: NaN payloads, -0.0,
    # ±inf, int32 sums that wrap (the card's add gives its canonical NaN
    # in kernel and plain version alike)
    rng = np.random.default_rng(23)
    for dtype in ("f32", "i32"):
        edge = [torch.from_numpy(ring_edge_input(rng, s_local, nb, dtype))
                .to(dev) for _ in range(ns)]
        got, want = rf.ring_fold_fused(edge, fms), rf.ring_fold_fused_plain(
            edge, fms)
        for k in range(ns):
            exact(f"ring_fold_fused ({dtype} edge bits)", got[k], want[k])
    # rows one element past a 16-byte boundary (views into a larger
    # tensor), at the path's cell count and at an odd one: the 4-byte
    # copies, on ragged tiles
    s_local = s_f[0].shape[0]
    for width in (nb, nb + 1):
        flat = [torch.from_numpy(ring_edge_input(
            rng, s_local + 1, width, "f32")).to(dev).reshape(-1)
            for _ in range(ns)]
        mis = [f[1:1 + s_local * width].view(s_local, width) for f in flat]
        got, want = rf.ring_fold_fused(mis, fms), rf.ring_fold_fused_plain(
            mis, fms)
        for k in range(ns):
            exact(f"ring_fold_fused (misaligned, {width} cells)", got[k],
                  want[k])
    m_all = sum(f.member.numel() for f in fms)
    # what the function must move: the member rows in, ns outputs out. The
    # ring's hops (2(ns - 1) stores and loads of the plane) are the
    # algorithm's, pass through L2 on one card, and are reported apart for
    # the cell where they cross cards
    fused_bytes = 4 * m_all * nb + 4 * ns * plane
    hop_bytes = 2 * 2 * (ns - 1) * 4 * plane
    arr_all = torch.cat(s_f)
    gid_all = torch.cat([gd.clamp(max=g) for gd in gids]).to(torch.int64)
    rows.append({
        "name": "ring_fold_fused", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "ring_fold_fused.cu",
        "replaces": "greptimedb_tpu/parallel/kernels/ring_fold.py:217 "
                    "_tpu_ring_fold_call",
        "launches": launches["ring_fold_fused"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.ring_fold_fused(s_f, fms)),
        "plain_ms": cuda_ms(lambda: rf.ring_fold_fused_plain(s_f, fms)),
        **bound(fused_bytes, m_all * nb + ns * fms[0].fb * plane),
        # the total once (not on every shard), over the shards' rows laid
        # end to end
        "library_ms": cuda_ms(lambda: torch.zeros(
            (g + 1, nb), device=dev).index_add_(0, gid_all, arr_all)),
        "ms_int32": cuda_ms(lambda: rf.ring_fold_fused(s_i, fms)),
        # the hop ring on the same inputs: K2's seed + ns - 1 fold_cont
        "hops_ms": cuda_ms(lambda: rf.ring_fold_blocks(s_f, fms)),
        # the wrappers' host time alone (events time = host time until
        # the launch + the kernels' time)
        "host_ms": host_ms(lambda: rf.ring_fold_fused(s_f, fms)),
        "hops_host_ms": host_ms(lambda: rf.ring_fold_blocks(s_f, fms)),
        "shape": {"shards": ns, "s_local": s_local, "nb": nb, "g": g,
                  "fb_local": fms[0].fb, "members": m_all},
        "bytes": fused_bytes, "bytes_hops": hop_bytes,
        "design": walk_design(rf, "ring_fold_fused"),
    })
    return rows


def walk_design(rf, row):
    """The constants that csrc/ring_fold_fused.cu was built with, as its
    library reports them: cells a tile, rows in a thread's ring of cp.async
    slots, rows a wait, rows in flight, the bytes of one copy on aligned
    and on misaligned rows, and 1 where this row's form runs full groups
    of rows unrolled. The tile must be the one the wrappers size the
    counts by."""
    from greptimedb_tpu_torch.parallel.kernels import build

    out = (ctypes.c_int * (6 + len(WALK_FORMS)))()
    build.load("ring_fold_fused").gtt_ring_fold_fused_design(out)
    keys = ("tile_cells", "ring_slots", "rows_per_wait", "rows_in_flight",
            "copy_bytes", "misaligned_copy_bytes")
    design = dict(zip(keys, out))
    design["unrolled_groups"] = out[6 + WALK_FORMS[row]]
    if design["tile_cells"] != rf._FUSED_CELLS:
        raise AssertionError(f"ring_fold_fused built with tiles of "
                             f"{design['tile_cells']} cells, the wrappers "
                             f"size them as {rf._FUSED_CELLS}")
    return design


def ring_edge_input(rng, s_local, nb, dtype):
    """One shard's (s_local, nb) states with the fold's edge bits: float32
    with wide magnitudes, -0.0 (a whole cell of it), ±inf in two cells of
    three and NaN payloads in the third; int32 with extremes whose sums
    wrap."""
    if dtype == "i32":
        x = rng.integers(-1000, 1000, (s_local, nb)).astype(np.int32)
        r = rng.random(x.shape)
        x[r < 0.05] = 2**31 - 1
        x[(r >= 0.05) & (r < 0.1)] = -(2**31)
        return x
    x = (rng.standard_normal((s_local, nb))
         * 10.0 ** rng.integers(-4, 5, (s_local, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    x[:, nb // 2] = -0.0
    inf_cell = np.arange(nb) % 3 != 0
    inf_cell[nb // 2] = False
    x[(r >= 0.1) & (r < 0.12) & inf_cell] = np.inf
    x[(r >= 0.12) & (r < 0.14) & inf_cell] = -np.inf
    nan = (r >= 0.14) & (r < 0.15) & ~inf_cell
    bits = (rng.integers(0, 2**22, x.shape) | 0x7FC00000).astype(np.uint32)
    x[nan] = bits.view(np.float32)[nan]
    return x


def mesh_phase(args, dev, P):
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    hosts = np.array([f"host_{i}" for i in range(args.mesh_hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.mesh_hosts)]
    table = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
                  fields=FIELDS)
    q1, q2 = make_plans(P)
    zero_counts(rf, mg)
    seconds = {}
    t = time.perf_counter()
    written = ingest(table, rng, hosts, region_of, args.mesh_hours)
    seconds["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    table.compact(device=dev, kernels="on")
    torch.cuda.synchronize()
    seconds["compact"] = time.perf_counter() - t
    compact_counts = counts(rf, mg)

    mesh = make_mesh([dev] * 4)
    engines = {
        "single": QueryEngine(device=dev),
        "ring": QueryEngine(device=dev, mesh=mesh),
        "gather": QueryEngine(device=dev, mesh=mesh,
                              mesh_opts=MeshOptions(pallas_kernels="off")),
    }
    results, per_engine, info = {}, {}, {}
    for name, eng in engines.items():
        zero_counts(rf, mg)
        timing, warm_launches = {}, {}
        for qn, plan in (("q1", q1), ("q2", q2)):
            t = time.perf_counter()
            results[name, qn] = eng.execute(plan, table)
            torch.cuda.synchronize()
            timing[f"{qn}_cold"] = time.perf_counter() - t
        for qn, plan in (("q1", q1), ("q2", q2)):
            times = []
            before = counts(rf, mg)
            for _ in range(5):
                t = time.perf_counter()
                eng.execute(plan, table)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            after = counts(rf, mg)
            warm_launches[qn] = {k: (after[k] - before[k]) / 5
                                 for k in after if after[k] > before[k]}
            timing[f"{qn}_warm_median"] = float(np.median(times))
            info[name, qn] = dict(eng.last_range)
        per_engine[name] = {"seconds": timing, "launches": counts(rf, mg),
                            "launches_per_warm_query": warm_launches,
                            "q1": info[name, "q1"], "q2": info[name, "q2"]}
    launches = {k: compact_counts[k] + sum(
        per_engine[e]["launches"][k] for e in engines) for k in compact_counts}

    ring_q2 = info["ring", "q2"]
    if (ring_q2["decision"] != "shard(large_grid)"
            or ring_q2["kernel"] != "ring(ring_fold)"
            or ring_q2["ring_form"] != "fused"
            or ring_q2["shards"] != 4):
        raise AssertionError(f"ring engine decided {ring_q2}")
    if info["gather", "q2"]["kernel"] != "gather(kernels_off)":
        raise AssertionError(f"gather engine decided {info['gather', 'q2']}")
    # every ring is one launch on shards that share the card: no seed,
    # continuation or hop combine on the ring engine (the hop ring runs in
    # phase 8)
    ring_l = per_engine["ring"]["launches"]
    for k in ONE_RING_KERNELS:
        if ring_l[k] == 0:
            raise AssertionError(f"{k} never launched on the ring engine")
    for k in HOP_KERNELS:
        if ring_l[k] != 0:
            raise AssertionError(f"{k} launched on the fused ring engine")
    warm_q2 = per_engine["ring"]["launches_per_warm_query"]["q2"]
    for k, n in {**Q2_RINGS, "extreme": 0, "onehot_add": 0}.items():
        if warm_q2.get(k, 0) != n:
            raise AssertionError(f"{k}: {warm_q2.get(k, 0)} launches per "
                                 f"warm mesh Q2 on the ring engine, not {n}")
    for k in RING_KERNELS:
        if per_engine["gather"]["launches"][k] != 0:
            raise AssertionError(f"{k} launched on the gather engine")
    for k, n in launches.items():
        if n == 0 and k not in ("fold_cont", *Q2_HOPS):
            raise AssertionError(f"kernel {k} never launched on the mesh "
                                 f"path")

    # ---- checks -------------------------------------------------------
    w1, w2 = HOUR_MS // STEP_MS, 2 * HOUR_MS // STEP_MS
    r1, r2 = results["single", "q1"], results["single", "q2"]
    if r1.num_rows != args.mesh_hosts * args.mesh_hours:
        raise AssertionError(f"mesh Q1 rows {r1.num_rows}")
    if r2.num_rows != len(set(region_of)) * (args.mesh_hours + 1):
        raise AssertionError(f"mesh Q2 rows {r2.num_rows}")
    means = {f"avg({f})" for f in FIELDS}
    checks = {}
    for name in ("ring", "gather"):
        compare_engines(f"{name} Q2", r2, results[name, "q2"], w2)
        ident, worst = compare_engines(f"{name} Q1", r1, results[name, "q1"],
                                       w1, bounded=means)
        checks[name] = {"q2_identical": True, "q1_identical": ident,
                        "q1_max_rel_diff": worst}
    compare_engines("ring vs gather Q2", results["ring", "q2"],
                    results["gather", "q2"], w2)

    # ---- kernels at the mesh path's shapes, and one warm profile -------
    ring = engines["ring"]
    entry = next(iter(ring.range_cache._entries.values()))
    memo = next(m for m in entry.query_memo.values() if m["fold"])
    t = time.perf_counter()
    rows = mesh_kernel_rows(dev, entry, memo, launches)
    kernel_seconds = time.perf_counter() - t
    profs = {name: profiled(lambda: eng.execute(q2, table))
             for name, eng in engines.items()}
    # the hop ring on the ring engine's grid (one warm-up run first): the
    # hop combines' device time, which the fused engine no longer launches
    with ring_form("hops"):
        ring.execute(q2, table)
        before = counts(rf, mg)
        profs["hops"] = profiled(lambda: ring.execute(q2, table))
        after = counts(rf, mg)
    hops_q2 = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    gather_q2 = per_engine["gather"]["launches_per_warm_query"]["q2"]
    for engine_name, warm, want in (("hop ring", hops_q2, Q2_HOP_FOLDS),
                                    ("gather", gather_q2, Q2_GATHER_FOLDS)):
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm mesh Q2 on the {engine_name} "
                                     f"engine, not {n}")
    # device time per launch on the warm Q2 (the events' times above
    # include the wrapper's host overhead when it outlasts the kernel)
    per_launch = {
        "extreme": device_ms_per_launch(
            profs["hops"], lambda k: k.startswith("extreme_")),
        "onehot_add": device_ms_per_launch(
            profs["hops"], lambda k: k.startswith("onehot_add")),
        "fold_cont": device_ms_per_launch(profs["hops"], walk("fold_cont")),
        "block_partials": device_ms_per_launch(profs["gather"],
                                               walk("block_partials")),
        "ring_fold_fused": device_ms_per_launch(profs["ring"],
                                                walk("ring_fold_fused")),
        "ring_pext_fused": device_ms_per_launch(profs["ring"],
                                                ring_combine(0, 1, 2, 3)),
        "ring_psum_onehot_fused": device_ms_per_launch(profs["ring"],
                                                       ring_combine(4)),
    }
    # launches per warm Q2 on the engine that runs each row: the walk's
    # single-shard forms on the hop ring and the gather twin, the rest on
    # the ring engine
    warm_by_row = {"fold_cont": hops_q2, "block_partials": gather_q2}
    for row in rows:
        if row["name"] in per_launch:
            row["device_ms_per_launch_q2"] = per_launch[row["name"]]
        row["launches_per_warm_q2"] = warm_by_row.get(
            row["name"], warm_q2).get(row["name"], 0)
    by_name = {row["name"]: row for row in rows}
    for name in WALK_FORMS:
        walk_row = by_name[name]
        dev_ms = walk_row.get("device_ms_per_launch_q2")
        if dev_ms:
            walk_row["share_of_bound"] = walk_row["bound_ms"] / dev_ms
            walk_row["achieved_gb_s"] = walk_row["bytes"] / dev_ms / 1e6
    for hop, one in (("extreme", "ring_pext_fused"),
                     ("onehot_add", "ring_psum_onehot_fused")):
        by_name[hop]["ring_device_ms_per_launch_q2"] = per_launch[one]
    a, b = (t.contiguous() for t in entry.fields["usage_user"]["mx"][:2])
    steps = launch_path_steps(a[:9], b[:9])
    emit({"phase": "mesh", "seconds": seconds, "rows_written": written,
          "hosts": args.mesh_hosts, "hours": args.mesh_hours,
          "grid": {"series": entry.num_series, "cells": entry.nb,
                   "shards": len(entry.devices),
                   "device_bytes": entry.bytes()},
          "engines": per_engine, "checks": checks, "launches": launches,
          "q2_hop_bytes": ring_q2["comm_bytes"],
          "hop_ring_launches_per_warm_q2": hops_q2,
          "q2_warm_profiles": profs, "kernel_seconds": kernel_seconds,
          "launch_path_ns": steps,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"rows": rows, "table": table, "engines": engines,
            "hosts": args.mesh_hosts,
            "hours": args.mesh_hours, "regions": len(set(region_of)),
            "q1": results["single", "q1"], "q2": results["single", "q2"]}


def launch_path_steps(a, b):
    """Host ns per call of each step that ring_fold's launch path took on
    every call before its launchers were bound once, and of what took
    their place: the median over 7 batches of 1000 calls (after 200
    warm-up calls; the card is synchronized between batches, outside the
    timing). `empty_call` is the loop's own cost, included in every other
    number. `a`, `b` are two (9, nb) float32 planes on the card."""
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    idx = a.get_device()
    dev = a.device
    entry = build.entry("ring_fold", "gtt_noop", ())
    lib, fn = entry
    stream = build.stream(idx)

    def bind():
        f = getattr(build.load("ring_fold"), "gtt_noop")
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_int

    def device_context():
        with torch.cuda.device(dev):
            pass

    def before_path():
        # the launch path as it was: bind, context, stream object, call
        f = getattr(build.load("ring_fold"), "gtt_noop")
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_int
        with torch.cuda.device(dev):
            rc = f(torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch(lib, rc, "noop")

    steps = {
        "empty_call": lambda: None,
        "load_lookup_and_type": bind,
        "bound_entry_lookup": lambda: build.entry("ring_fold", "gtt_noop",
                                                  ()),
        "device_context": device_context,
        "current_device_check": lambda: torch._C._cuda_getDevice() == idx,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: build.stream(idx),
        "check_pair": lambda: rf._check_pair("extreme", a, b,
                                             rf._FOLD_TYPES),
        "check_ring_4": lambda: rf._check_ring("ring_pext_fused",
                                               [a, b, a, b], rf._FOLD_TYPES),
        "shard_pointer_array_4": lambda: build.SHARD_PTRS(
            a.data_ptr(), b.data_ptr(), a.data_ptr(), b.data_ptr()),
        "device_type_check": lambda: a.device.type == "cpu",
        "is_cpu": lambda: a.is_cpu,
        "empty_like": lambda: torch.empty_like(a),
        "new_empty": lambda: a.new_empty(a.shape),
        "ring_form_4": lambda: rf.RingFoldCtx(4).form(
            [x.device for x in (a, b, a, b)]),
        "noop_ctypes_call": lambda: fn(stream),
        "noop_launch_before": before_path,
        "noop_launch_bound": lambda: build.launch(entry, "noop", idx),
    }
    return time_steps(steps)


def is_seed_kernel(k):
    """Profiler-name matcher of K2's seed in either form, fold_kernel<T>
    (per cell) or fold_staged_kernel<T> (staged)."""
    return k.startswith(("fold_kernel<", "fold_staged_kernel<"))


# the forms of the pipelined member walk, ring_fold_fused_kernel<T,
# aligned, form> (csrc/ring_fold_fused.cu kRing, kCont, kPartials)
WALK_FORMS = {"ring_fold_fused": 0, "fold_cont": 1, "block_partials": 2}


def walk(row):
    """Profiler-name matcher of one row's form of the member walk: the
    fused ring (row 6), fold_cont (row 3) or block_partials, each
    matching its own launches only."""
    form = str(WALK_FORMS[row])
    return lambda k: (k.startswith("ring_fold_fused_kernel<")
                      and k.rstrip(">").rsplit(",", 1)[-1].strip() == form)


def ring_combine(*ops):
    """Profiler-name matcher of the one-launch ring combines,
    ring_combine_kernel<T, op, vec>: ops 0-3 the extreme (f32 max, min,
    int32 max, min), 4 the one-hot sum."""
    return lambda k: (k.startswith("ring_combine_kernel<")
                      and int(k.split(",")[1]) in ops)


PROM_T0 = 1_700_000_000_000
PROM_QUERIES = ("sum by (dc) (rate(prom_bench[1m]))",
                "topk(5, rate(prom_bench[1m]))",
                "topk(100, rate(prom_bench[1m]))",
                "bottomk(100, rate(prom_bench[1m]))")
# bench.py's query span: start t0 + 60 s, end t0 + 270 s, step 30 s
PROM_SPAN = (PROM_T0 + 60_000, PROM_T0 + 270_000, 30_000)


def prom_ingest(table, n_series):
    """bench.py's prom_bench data: n_series series (host_i, dc = i % 32),
    10 samples at 30 s, each a fresh cumsum of seeded uniforms plus 50
    per sample. Returns rows written."""
    hosts = np.asarray([f"host_{i}" for i in range(n_series)], object)
    dcs = np.asarray([f"dc{i % 32}" for i in range(n_series)], object)
    rng = np.random.default_rng(11)
    written = 0
    for s in range(10):
        ts = np.full(n_series, PROM_T0 + s * 30_000, np.int64)
        written += table.write(
            {"host": hosts, "dc": dcs}, ts,
            {"greptime_value": np.cumsum(rng.random(n_series)) + s * 50.0})
    return written


def same_vector(a, b) -> bool:
    """Two PromQL vectors: labels in order, presence, and the float32 bits
    of every present value."""
    if a.labels != b.labels or not np.array_equal(a.present, b.present):
        return False
    va = a.values[a.present].astype(np.float32).view(np.uint32)
    vb = b.values[b.present].astype(np.float32).view(np.uint32)
    return bool(np.array_equal(va, vb))


def topk_kernel_rows(dev, ring_entry, launches, per_launch):
    """Row 7 (the merge hop) and row 7r (the ring topk in one launch) at
    the ring's shapes (every shard's candidates of the warm topk(100)
    query: J = 8, k = kl = 100, four shards) and on edge cases, held
    against their plain versions bit for bit and timed."""
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.promql import fast as TF
    from greptimedb_tpu_torch.promql.engine import EvalParams

    ev = EvalParams(*PROM_SPAN)
    win = TF._plan_windows(ring_entry, ev, 60_000, 0)
    smask, _ = TF._matcher_mask_dev(ring_entry, [])
    ns = ring_entry.shards
    s_loc = ring_entry.s_pad // ns
    cands = []
    outs, press = TF._eval_shards(ring_entry, smask, win, fname="rate",
                                  fargs=(), lookback_ticks=300_000)
    for s, (out, pres) in enumerate(zip(outs, press)):
        cands.append(TF._local_candidates(
            out, pres, TF._topk_key(out, pres, True), 100, s * s_loc))
    acc, loc = cands[:2]

    def same(got, want, what):
        """Raise unless every plane agrees bit for bit; the largest
        absolute difference of the planes' values (NaN - NaN and
        inf - inf left out)."""
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            gi = g.view(torch.int32) if g.dtype == torch.float32 else g
            wi = w.view(torch.int32) if w.dtype == torch.float32 else w
            if not torch.equal(gi, wi):
                raise AssertionError(f"{what} differs")
            d = (g.double() - w.double()).abs()
            d = d[~d.isnan()]
            if d.numel():
                err = max(err, float(d.max()))
        return err

    errs = {"hop": 0.0, "ring": 0.0}

    def check(a, b, what):
        errs["hop"] = max(errs["hop"], same(
            tm.merge_candidates(a, b), tm.merge_candidates_plain(a, b),
            f"merge_candidates ({what}) from its plain version"))

    def check_ring(local, k, what):
        got = tm.ring_topk_merge_fused(local, k)[0]
        errs["ring"] = max(errs["ring"], same(
            got, tm.ring_topk_merge_fused_plain(local, k)[0],
            f"ring_topk_merge_fused ({what}) from its plain version"))
        same(got, tm.ring_topk_merge_hops(local, k)[0],
             f"ring_topk_merge_fused ({what}) from the hop ring")

    check(acc, loc, "main path")
    check_ring(cands, 100, "main path")
    rng = np.random.default_rng(7)

    def edge(j, width, sort=True):
        key = rng.choice(np.array([2.0, 1.0, 0.0, -0.0, -np.inf],
                                  np.float32), (j, width))
        if sort:
            key = -np.sort(-key, axis=1)
        else:
            key[rng.random((j, width)) < 0.1] = np.nan
        val = rng.standard_normal((j, width)).astype(np.float32)
        val[:, ::3] = -0.0
        val[:, 1::5] = np.frombuffer(np.full(
            val[:, 1::5].size, 0x7FC12345, np.uint32).tobytes(), np.float32
        ).reshape(val[:, 1::5].shape)
        idx = rng.integers(0, 2**31 - 1, (j, width)).astype(np.int32)
        pres = rng.random((j, width)) < 0.8
        return tm.Candidates(*(torch.from_numpy(np.ascontiguousarray(p))
                               .to(dev) for p in (key, val, idx, pres)))

    check(edge(8, 100), edge(8, 100), "cross-list ties, -inf, NaN, -0.0")
    check(edge(8, 100), edge(8, 37), "kl < kk")
    check(edge(5, 64, sort=False), edge(5, 64, sort=False), "unsorted")
    check_ring([edge(8, 100) for _ in range(4)], 100,
               "cross-list ties, -inf, NaN, -0.0")
    check_ring([edge(8, 37) for _ in range(4)], 100, "kl < k")
    check_ring([edge(5, 64, sort=False) for _ in range(8)], 64,
               "unsorted, NaN keys, 8 shards")

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    j, kk = acc.key.shape
    kl = loc.key.shape[1]
    hop_bytes = 13 * j * (kk + kl) + 13 * j * kk
    cat_key = torch.cat([acc.key, loc.key], dim=1)
    ring_bytes = 13 * j * (kk + (ns - 1) * kl) + 13 * j * kk
    ring_ops = 2 * (ns - 1) * j * kk * kl
    ring_key = torch.cat([c.key for c in cands], dim=1)
    src = "greptimedb_tpu_torch/parallel/kernels/csrc/topk_merge.cu"
    ring = {
        "ring_ms": cuda_ms(lambda: tm.ring_topk_merge_fused(cands, kk)),
        "ring_host_ms": host_ms(lambda: tm.ring_topk_merge_fused(cands, kk)),
        "ring_device_ms_per_launch": per_launch["ring_topk_merge_fused"],
        "ring_bound_ms": bound(ring_bytes, ring_ops)["bound_ms"],
        "ring_plain_ms": cuda_ms(
            lambda: tm.ring_topk_merge_fused_plain(cands, kk)),
        # the one library call that selects the same top k
        "library_ms_ring": cuda_ms(
            lambda: torch.topk(ring_key, kk, dim=1)),
        # the hop chain on the same inputs: ns - 1 merge launches
        "hops_ms": cuda_ms(lambda: tm.ring_topk_merge_hops(cands, kk)),
        "hops_host_ms": host_ms(lambda: tm.ring_topk_merge_hops(cands, kk)),
    }
    hop = {
        "name": "merge_candidates", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/topk_merge.py:87 "
                    "(merge_candidates, body _merge_topk_kernel:29)",
        "launches": launches["merge_candidates"],
        "max_abs_err": errs["hop"],
        "ms": cuda_ms(lambda: tm.merge_candidates(acc, loc)),
        "host_ms": host_ms(lambda: tm.merge_candidates(acc, loc)),
        "plain_ms": cuda_ms(lambda: tm.merge_candidates_plain(acc, loc)),
        **bound(hop_bytes, 2 * j * kk * kl),
        "library_ms": cuda_ms(lambda: torch.topk(cat_key, kk, dim=1)),
        "device_ms_per_launch": per_launch["merge_candidates"],
        **ring,
        "shape": {"J": j, "kk": kk, "kl": kl}, "bytes": hop_bytes,
        "launch_path_ns": topk_launch_path_steps(acc, loc),
    }
    fused = {
        "name": "ring_topk_merge_fused", "route": "cuda", "source": src,
        "replaces": "greptimedb_tpu/parallel/kernels/topk_merge.py:103 "
                    "ring_topk_merge (the chain of merge_candidates:87 "
                    "hops through sequential_ring)",
        "launches": launches["ring_topk_merge_fused"],
        "max_abs_err": errs["ring"],
        "ms": ring["ring_ms"], "host_ms": ring["ring_host_ms"],
        "plain_ms": ring["ring_plain_ms"], **bound(ring_bytes, ring_ops),
        "library_ms": ring["library_ms_ring"],
        "device_ms_per_launch": ring["ring_device_ms_per_launch"],
        "hops_ms": ring["hops_ms"], "hops_host_ms": ring["hops_host_ms"],
        "shape": {"shards": ns, "J": j, "k": kk, "kl": kl},
        "bytes": ring_bytes,
    }
    return [hop, fused]


def topk_launch_path_steps(acc, loc):
    """Host ns per call of each step of merge_candidates' launch path as it
    was before it was bound once, and of what took each step's place (as
    launch_path_steps does for ring_fold). `acc`, `loc` are (J, 100)
    candidate planes on the card."""
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm

    dev = acc.key.device
    idx = acc.key.get_device()
    j, kk = acc.key.shape
    kl = loc.key.shape[1]
    types = (torch.float32, torch.float32, torch.int32, torch.bool)

    def check_before():
        # the per-plane checks as they were
        for planes in (acc, loc):
            for p, t in zip(planes, types):
                if p.dtype != t:
                    raise TypeError
                if p.dim() != 2 or p.shape != planes.key.shape:
                    raise ValueError
                if p.device != acc.key.device:
                    raise ValueError
                if not p.is_contiguous():
                    raise ValueError

    def check_now():
        tm._check("acc", acc)
        tm._check("loc", loc)

    def bind():
        f = build.load("topk_merge").gtt_merge_topk
        f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int

    def device_context():
        with torch.cuda.device(dev):
            pass

    def two_allocations():
        # one int32 (3, J, kk) buffer (key, value, index as views) and one
        # bool presence plane
        buf = torch.empty((3, j, kk), dtype=torch.int32, device=dev)
        return (buf[0].view(torch.float32), buf[1].view(torch.float32),
                buf[2], torch.empty((j, kk), dtype=torch.bool, device=dev))

    out = tm._alloc(acc, j, kk)
    entry = build.entry("topk_merge", "gtt_merge_topk",
                        (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3)
    ptrs = [p.data_ptr() for p in (*acc, *loc, *out)]

    def launch_before():
        lib = build.load("topk_merge")
        fn = lib.gtt_merge_topk
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*ptrs, j, kk, kl, stream)
        build.check_launch(lib, rc, "merge_candidates")

    steps = {
        "empty_call": lambda: None,
        "check_before": check_before,
        "check": check_now,
        # ring_topk_merge_fused's checks over four shards
        "check_ring_4": lambda: [tm._check("ring", c)
                                 for c in (acc, loc, acc, loc)],
        "load_lookup_and_type": bind,
        "bound_entry_lookup": lambda: build.entry(
            "topk_merge", "gtt_merge_topk",
            (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3),
        "device_context": device_context,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: build.stream(idx),
        "empty_like_4": lambda: [torch.empty_like(p) for p in acc],
        "empty_4": lambda: [torch.empty((j, kk), dtype=t, device=dev)
                            for t in types],
        "alloc": lambda: tm._alloc(acc, j, kk),
        "alloc_2_and_views": two_allocations,
        "data_ptr_12": lambda: [p.data_ptr() for p in (*acc, *loc, *out)],
        "launch_before": launch_before,
        "launch_bound": lambda: build.launch(entry, "merge_candidates", idx,
                                             *ptrs, j, kk, kl),
        "merge_candidates": lambda: tm.merge_candidates(acc, loc),
    }
    return time_steps(steps)


def time_steps(steps):
    """Host ns per call of each step: the median over 7 batches of 1000
    calls (after 200 warm-up calls; the card is synchronized between
    batches, outside the timing)."""
    out = {}
    for name, step in steps.items():
        for _ in range(200):
            step()
        torch.cuda.synchronize()
        batches = []
        for _ in range(7):
            t = time.perf_counter_ns()
            for _ in range(1000):
                step()
            batches.append((time.perf_counter_ns() - t) / 1000)
            torch.cuda.synchronize()
        out[name] = float(np.median(batches))
    return out


def promql_phase(args, dev):
    import types

    from greptimedb_tpu_torch.catalog.manager import CatalogManager
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.promql import fast as TF
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    n = args.prom_series
    table = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
                  fields=["greptime_value"])
    t = time.perf_counter()
    written = prom_ingest(table, n)
    seconds = {"ingest": time.perf_counter() - t}
    catalog = CatalogManager()
    catalog.register(table)

    # the phase runs in the JAX package's x64 mode (h takes G's float64
    # sum form); h runs once more without it below
    def engine(device, mesh=None, opts=None, x64=True):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=x64)))

    mesh = make_mesh([dev] * 4)
    engines = {"single": engine(dev), "ring": engine(dev, mesh),
               "gather": engine(dev, mesh,
                                MeshOptions(pallas_kernels="off"))}
    # the ring engine's topk queries again with the ring hop by hop
    # (merge_candidates, ns - 1 launches a ring), after the other engines
    runs = [(name, eng, "fused", PROM_QUERIES)
            for name, eng in engines.items()]
    runs.append(("hops", engines["ring"], "hops", PROM_QUERIES[1:]))
    results, per_engine, notes = {}, {}, {}

    def topk_counts():
        return {k: getattr(tm, k).launches for k in TOPK_KERNELS}

    for name, eng, form, queries in runs:
        stats = {}
        for q in queries:
            run = (lambda eng=eng, q=q: eng.query_range(q, *PROM_SPAN)[0])
            with ring_form(form):
                for k in TOPK_KERNELS:
                    getattr(tm, k).launches = 0
                t = time.perf_counter()
                results[name, q] = run()
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                cold_launches = topk_counts()
                times = []
                for k in TOPK_KERNELS:
                    getattr(tm, k).launches = 0
                for _ in range(5):
                    t = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                warm_launches = topk_counts()
                prof = profiled(run)
            notes[name, q] = dict(eng.last_fast)
            stats[q] = {"cold_s": cold, "warm_median_s": float(
                np.median(times)), "launches_cold": cold_launches,
                "launches_per_warm": {k: n / 5 for k, n in
                                      warm_launches.items()},
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"], "top": prof["top"],
                "ours": prof["ours"], "note": notes[name, q]}
        per_engine[name] = stats

    # ---- checks -------------------------------------------------------
    topk_qs = PROM_QUERIES[1:]
    # per warm topk query: one ring launch on shards that share the card,
    # ns - 1 merge hops on the hop ring, none elsewhere
    want_launches = {
        "ring": {"ring_topk_merge_fused": 1, "merge_candidates": 0},
        "hops": {"ring_topk_merge_fused": 0, "merge_candidates": 3},
        "gather": {"ring_topk_merge_fused": 0, "merge_candidates": 0},
        "single": {"ring_topk_merge_fused": 0, "merge_candidates": 0},
    }
    for q in PROM_QUERIES:
        for name in ("ring", "gather", "hops"):
            if (name, q) in results and not same_vector(
                    results["single", q], results[name, q]):
                raise AssertionError(f"promql {name} differs from one "
                                     f"device on {q}")
        note = notes["ring", q]
        if note["decision"] != "shard(large_grid)" or note["shards"] != 4:
            raise AssertionError(f"ring engine decided {note} on {q}")
        if q in topk_qs and note["kernel"] != "ring(ring_topk)":
            raise AssertionError(f"ring engine kernel {note} on {q}")
        for name, want in want_launches.items():
            if q not in per_engine[name]:
                continue
            got = per_engine[name][q]["launches_per_warm"]
            want = want if q in topk_qs else {k: 0 for k in want}
            if got != want:
                raise AssertionError(f"topk launches per warm {q} on the "
                                     f"{name} engine: {got}, not {want}")
    agg = results["single", PROM_QUERIES[0]]
    if agg.num_series != 32 or not agg.present.all():
        raise AssertionError(f"aggregate has {agg.num_series} groups")
    for q in topk_qs:
        v = results["single", q]
        if not np.isfinite(v.values[v.present]).all():
            raise AssertionError(f"non-finite winners on {q}")
        k = int(q.split("(")[1].split(",")[0])
        if not (v.present.sum(axis=0) == k).all():
            raise AssertionError(f"{q}: not {k} winners at every step")
    t = time.perf_counter()
    cpu = engine("cpu")
    cpu_res = {q: cpu.query_range(q, *PROM_SPAN)[0] for q in PROM_QUERIES}
    seconds["cpu_reference"] = time.perf_counter() - t
    for q in topk_qs:
        if not same_vector(results["single", q], cpu_res[q]):
            raise AssertionError(f"promql one device differs from the CPU "
                                 f"on {q}")
    # the aggregate: both runs add each fold block's rows in a float32
    # matrix product, in cuBLAS's order on the card and the CPU BLAS's
    # here: |diff| <= 2 gamma_n sum |x_i|, n = rows per block + 8 blocks
    a, c = results["single", PROM_QUERIES[0]], cpu_res[PROM_QUERIES[0]]
    if a.labels != c.labels or not np.array_equal(a.present, c.present):
        raise AssertionError("aggregate groups differ from the CPU run")
    s_pad = 1 << max(3, (n - 1).bit_length())
    rows = s_pad // 8 + 8
    gamma = rows * U / (1 - rows * U)
    rates = results["single", "topk(100, rate(prom_bench[1m]))"]
    max_rate = float(np.abs(rates.values[rates.present]).max())
    members = np.bincount(np.arange(n) % 32, minlength=32)
    bound = 2 * gamma * members[:, None] * max_rate
    diff = np.abs(a.values - c.values)
    if not np.all(diff <= bound):
        raise AssertionError("aggregate past the matrix-product bound")
    agg_rel = float(np.max(diff / np.abs(c.values)))

    # ---- a repeated dashboard poll: the query session ------------------
    # topk(100) on the ring engine with sessions on: the first poll runs
    # the program (its ring topk launch), the repeat serves the resident
    # result and launches nothing, bit for bit the same answer
    from greptimedb_tpu_torch.query import sessions

    q_poll = "topk(100, rate(prom_bench[1m]))"
    ring_eng = engines["ring"]
    sessions.configure({"enable": True})
    try:
        polled, session = [], {}
        for _ in range(2):
            before = topk_counts()
            t = time.perf_counter()
            polled.append(ring_eng.query_range(q_poll, *PROM_SPAN)[0])
            torch.cuda.synchronize()
            hit = ring_eng.last_fast["session"]
            session[hit] = {"ms": (time.perf_counter() - t) * 1e3,
                            "launches": {k: n - before[k] for k, n in
                                         topk_counts().items()}}
    finally:
        sessions.configure({"enable": False})
    if sorted(session) != ["hit", "miss"] or \
            session["miss"]["launches"]["ring_topk_merge_fused"] != 1 or \
            any(session["hit"]["launches"].values()):
        raise AssertionError(f"promql repeated poll: {session}")
    a, b = polled
    if a.labels != b.labels or not np.array_equal(a.present, b.present) \
            or not np.array_equal(a.values.view(np.uint64),
                                  b.values.view(np.uint64)) \
            or not same_vector(a, results["ring", q_poll]):
        raise AssertionError("promql repeated poll: the session hit "
                             "differs from the first answer")

    # ---- the topk kernels --------------------------------------------
    ring_entry = next(e for k, e in TF._CACHE._entries.items()
                      if k[3] is not None and k[4] is None)
    q100 = "topk(100, rate(prom_bench[1m]))"
    per_launch = {
        "ring_topk_merge_fused": device_ms_per_launch(
            per_engine["ring"][q100], lambda k: k.startswith(
                "ring_topk_merge")),
        "merge_candidates": device_ms_per_launch(
            per_engine["hops"][q100], lambda k: k.startswith("merge_topk")),
    }
    # every launch of the main-path runs: the one-launch ring on the ring
    # engine, the merge hop on the hop ring
    launches = {k: int(sum(
        st["launches_cold"][k] + 5 * st["launches_per_warm"][k]
        for e in ("ring", "hops") for st in per_engine[e].values())
        + session["miss"]["launches"][k]) for k in TOPK_KERNELS}
    for k, count in launches.items():
        if count == 0:
            raise AssertionError(f"{k} never launched in phase promql")
    rows = topk_kernel_rows(dev, ring_entry, launches, per_launch)
    emit({"phase": "promql", "seconds": seconds, "rows_written": written,
          "series": n, "grid": {"s_pad": ring_entry.s_pad,
                                "cells": ring_entry.spec.num_cells,
                                "device_bytes": ring_entry.nbytes},
          "engines": per_engine,
          "checks": {"engines_identical": True, "topk_equal_cpu": True,
                     "agg_max_rel_diff_vs_cpu": agg_rel,
                     "agg_groups": agg.num_series},
          "ring_comm_bytes": notes["ring", topk_qs[1]]["comm_bytes"],
          "repeated_poll": {"query": q_poll, **session},
          "phase_seconds": time.perf_counter() - t_phase})
    return rows, {"catalog": catalog, "series": n, "engine": engine,
                  "engines": engines, "max_rate": max_rate,
                  "members": members, "gamma": gamma}


# ---- phase 10: promql_rest -------------------------------------------

HIST_LES = ("0.05", "0.1", "0.25", "0.5", "1", "2.5", "5", "+Inf")
HIST_SERVICES = 50
# bench.py's histogram span: t0 + 60 s to t0 + 270 s at 30 s (8 steps)
HIST_SPAN = (PROM_T0 + 60_000, PROM_T0 + 270_000, 30_000)
REST_E = "histogram_quantile(0.9, sum by (le, svc) (rate(hist_bucket[1m])))"
# name -> (query, span, branch of its aggregation): "matmul" results are
# held to the CPU run within their bound, the others bit for bit
REST_QUERIES = {
    "a": ("sum by (dc) (rate(prom_bench[1m]) / "
          "last_over_time(prom_bench[1m]))", PROM_SPAN, "matmul"),
    "b": ("sum by (dc) (quantile_over_time(0.9, prom_bench[2m]))",
          PROM_SPAN, "matmul"),
    "c": ("max by (dc) (deriv(prom_bench[2m]))", PROM_SPAN, "extreme"),
    "d": ("sum by (dc) (holt_winters(prom_bench[2m], 0.5, 0.5))",
          PROM_SPAN, "matmul"),
    "e": (REST_E, HIST_SPAN, "matmul"),
    "f": ("histogram_quantile(0.9, sum by (le, pod) "
          "(rate(hist_bucket[1m])))", HIST_SPAN, "scatter"),
    "g_instant": (REST_E, None, "matmul"),
    "g_range": ("rate(hist_bucket[1m]) > 1", HIST_SPAN, "none"),
    # the per-pod panel as an instant query: the generic engine's float64
    # vectors through the scatter branch, G's float64 sum form
    "h": ("histogram_quantile(0.9, sum by (le, pod) "
          "(rate(hist_bucket[1m])))", None, "scatter"),
}
# the card's matrix products on a, b and d are also held to a limit set
# from readings: MATMUL_READ_K sqrt(n) u sum|x| (PERF.md section 6)
MATMUL_READ_K = 8
# the inner sums behind the histogram quantiles, and the per-group
# member magnitudes behind the sums' bounds (one device, untimed)
REST_AUX = {
    "a": "{op} by (dc) (rate(prom_bench[1m]) / "
         "last_over_time(prom_bench[1m]))",
    "b": "{op} by (dc) (quantile_over_time(0.9, prom_bench[2m]))",
    "d": "{op} by (dc) (holt_winters(prom_bench[2m], 0.5, 0.5))",
}


def hist_ingest(table, pods):
    """bench.py's hist_bucket (bench.py:2575-2616): `pods` pods x 8 le
    buckets, pod i in svc_(i % 50), 10 samples at 30 s from seed 13,
    cumulative over time and over buckets. Returns rows written."""
    n_series = pods * len(HIST_LES)
    pod_col = np.repeat(np.asarray([f"pod_{i}" for i in range(pods)],
                                   object), len(HIST_LES))
    svc_col = np.repeat(np.asarray([f"svc_{i % HIST_SERVICES}"
                                    for i in range(pods)], object),
                        len(HIST_LES))
    le_col = np.tile(np.asarray(HIST_LES, object), pods)
    rng = np.random.default_rng(13)
    per_bucket = rng.random((n_series,)) * 5.0
    base = np.cumsum(per_bucket.reshape(pods, len(HIST_LES)), axis=1).ravel()
    written = 0
    for s in range(10):
        ts = np.full(n_series, PROM_T0 + s * 30_000, np.int64)
        written += table.write({"pod": pod_col, "svc": svc_col,
                                "le": le_col}, ts,
                               {"greptime_value": base * (s + 1)})
    return written


def run_rest_query(eng, name):
    query, span, _ = REST_QUERIES[name]
    if span is None:     # an instant query at the last step, steps 1 s
        return eng.query_instant(query, HIST_SPAN[1])[0]
    return eng.query_range(query, *span)[0]


def quantile_gap_bound(sums, le, q, bound):
    """The largest change of histogram_quantile(q) over buckets whose
    cumulative sums move by at most `bound` each (same bucket located):
    out = lb + (ub - lb) (rank - lo) / (hi - lo) with rank = q total, so
    |d out| <= (ub - lb) (q + 1 + 2 frac) bound / width. sums: (B, J)
    of one group in le order."""
    b = np.maximum.accumulate(np.where(np.isnan(sums), 0, sums), axis=0)
    total = b[-1]
    rank = q * total
    idx = np.clip((b < rank[None, :]).sum(axis=0), 0, len(le) - 1)
    lo = np.where(idx > 0, b[np.maximum(idx - 1, 0), np.arange(b.shape[1])],
                  0)
    hi = b[idx, np.arange(b.shape[1])]
    width = np.where(hi - lo == 0, 1, hi - lo)
    ub = le[idx]
    lb = np.where(idx > 0, le[np.maximum(idx - 1, 0)], 0)
    span = np.where(np.isfinite(ub), ub - lb, 0)
    frac = np.clip((rank - lo) / width, 0, 1)
    return span * (q + 1 + 2 * frac) * bound / width


def promql_rest_phase(args, dev, prom, add_ns):
    """Phase 10 (see the module docstring). Returns every kernel's
    launches over the phase's main path, G's numbers at query f's shape
    and K2's at query c's (its chain bound at `add_ns` a dependent add)."""
    import types

    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.query.executor import QueryEngine

    t_phase = time.perf_counter()
    catalog = prom["catalog"]
    hist = Table("hist_bucket", ts_name="ts", tag_names=["pod", "svc", "le"],
                 fields=["greptime_value"])
    t = time.perf_counter()
    written = hist_ingest(hist, args.hist_pods)
    seconds = {"hist_ingest": time.perf_counter() - t}
    catalog.register(hist)

    # the phase runs in the JAX package's x64 mode (h takes G's float64
    # sum form); h runs once more without it below
    def engine(device, mesh=None, opts=None, x64=True):
        return PromEngine(types.SimpleNamespace(
            catalog=catalog, query_engine=QueryEngine(
                device=device, mesh=mesh, mesh_opts=opts, x64=x64)))

    mesh = make_mesh([dev] * 4)
    engines = {"single": engine(dev), "ring": engine(dev, mesh),
               "gather": engine(dev, mesh,
                                MeshOptions(pallas_kernels="off"))}

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS},
                **{k: getattr(tm, k).launches for k in TOPK_KERNELS}}

    def zero_all():
        zero_counts(rf, mg)
        for k in GROUPED_KERNELS:
            getattr(gr, k).launches = 0
        for k in TOPK_KERNELS:
            getattr(tm, k).launches = 0

    results, stats, notes = {}, {}, {}
    launches = {}
    store = {}
    for ename, eng in engines.items():
        per_q = {}
        for name in REST_QUERIES:
            run = (lambda eng=eng, name=name: run_rest_query(eng, name))
            zero_all()
            eng.last_fast = None
            t = time.perf_counter()
            k2_here = (capture_k2(rf, store)
                       if (ename, name) == ("single", "c")
                       else contextlib.nullcontext())
            with capture_grouped(gr, store), k2_here:
                results[ename, name] = run()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t
            cold_launches = all_counts()
            zero_all()
            times = []
            for _ in range(args.rest_warm):
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            warm_launches = all_counts()
            prof = profiled(run, top=5)
            notes[ename, name] = eng.last_fast
            for k in set(cold_launches) | set(warm_launches):
                launches[k] = (launches.get(k, 0) + cold_launches.get(k, 0)
                               + warm_launches.get(k, 0))
            per_q[name] = {
                "cold_s": cold, "warm_median_s": float(np.median(times)),
                "launches_cold": {k: v for k, v in cold_launches.items()
                                  if v},
                "launches_per_warm": {k: v / args.rest_warm
                                      for k, v in warm_launches.items()
                                      if v},
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"], "top": prof["top"],
                "ours": prof["ours"], "note": notes[ename, name],
                "series": results[ename, name].num_series}
        stats[ename] = per_q

    # ---- checks -------------------------------------------------------
    for name, (query, span, branch) in REST_QUERIES.items():
        ref = results["single", name]
        for ename in ("ring", "gather"):
            if not same_vector(ref, results[ename, name]):
                raise AssertionError(f"promql_rest {ename} differs from one "
                                     f"device on {name}: {query}")
        if ref.num_series == 0 or not ref.present.any():
            raise AssertionError(f"promql_rest {name} answered nothing")
        for ename in engines:
            got = stats[ename][name]["launches_per_warm"]
            g_launch = got.get("grouped_block_reduce", 0)
            # one G launch a step column of f's and h's sums, none
            # elsewhere
            want_g = len(results[ename, name].present[0]) \
                if branch == "scatter" else 0
            if g_launch != want_g:
                raise AssertionError(f"G launched {g_launch} times per warm "
                                     f"{name} on {ename}, not {want_g}")
            p_launch = got.get("ring_pext_fused", 0)
            want_p = 1 if (name == "c" and ename == "ring") else 0
            if p_launch != want_p:
                raise AssertionError(f"4r launched {p_launch} times per warm "
                                     f"{name} on {ename}, not {want_p}")
            # K2 folds c's count on one device, once a query
            k_launch = got.get("blocked_fold_sum", 0)
            want_k = 1 if (name == "c" and ename == "single") else 0
            if k_launch != want_k:
                raise AssertionError(f"K2 launched {k_launch} times per warm "
                                     f"{name} on {ename}, not {want_k}")
    for name in ("a", "b", "c", "d"):
        if results["single", name].num_series != 32:
            raise AssertionError(f"{name}: not 32 dc groups")
    if results["single", "e"].num_series != HIST_SERVICES:
        raise AssertionError("e: not one quantile per service")
    for name in ("f", "h"):
        if results["single", name].num_series != args.hist_pods:
            raise AssertionError(f"{name}: not one quantile per pod")
    for name in REST_QUERIES:
        v = results["single", name]
        if not np.isfinite(v.values[v.present]).all():
            raise AssertionError(f"{name}: non-finite values")

    # h without x64 (the JAX package's default): float32 vectors through
    # G's float32 sum form, one launch a warm query, exact against the
    # port on the CPU in the same mode
    h32 = engine(dev, x64=False)
    zero_all()
    got32 = run_rest_query(h32, "h")
    torch.cuda.synchronize()
    h32_cold = all_counts()
    zero_all()
    run_rest_query(h32, "h")
    torch.cuda.synchronize()
    h32_warm = all_counts()
    for k in set(h32_cold) | set(h32_warm):
        launches[k] = (launches.get(k, 0) + h32_cold.get(k, 0)
                       + h32_warm.get(k, 0))
    if h32_warm.get("grouped_block_reduce") != 1:
        raise AssertionError(f"h without x64 launched G "
                             f"{h32_warm.get('grouped_block_reduce')} times "
                             f"a warm query, not 1")
    if not same_vector(got32, run_rest_query(engine("cpu", x64=False), "h")):
        raise AssertionError("h without x64 differs from the CPU")
    h32_note = {"launches_per_warm": h32_warm["grouped_block_reduce"],
                "exact_equal_cpu": True}

    # the port on the CPU: bit for bit where no matrix product adds, else
    # within 2 gamma_n sum|x| over a group's members (n: the product's
    # length: S_pad, or per fold block S_pad / 8 + 8 on the blocked path)
    t = time.perf_counter()
    cpu = engine("cpu")
    cpu_res = {name: run_rest_query(cpu, name) for name in REST_QUERIES}
    seconds["cpu_reference"] = time.perf_counter() - t
    rel, read = {}, {}
    s_pad = 1 << max(3, (prom["series"] - 1).bit_length())
    for name, (query, span, branch) in REST_QUERIES.items():
        a, c = results["single", name], cpu_res[name]
        if branch != "matmul":
            if not same_vector(a, c):
                raise AssertionError(f"promql_rest one device differs from "
                                     f"the CPU on {name}: {query}")
            continue
        if a.labels != c.labels or not np.array_equal(a.present, c.present):
            raise AssertionError(f"{name}: groups differ from the CPU run")
        diff = np.abs(a.values - c.values)[a.present]
        rel[name] = float(np.max(diff / np.maximum(np.abs(c.values[
            c.present]), 1e-30)))
        if name in REST_AUX:
            n = s_pad if name == "a" else s_pad // 8 + 8
            gamma = n * U / (1 - n * U)
            eng1 = engines["single"]
            mx = eng1.query_range(REST_AUX[name].format(op="max"),
                                  *span)[0]
            mn = eng1.query_range(REST_AUX[name].format(op="min"),
                                  *span)[0]
            cnt = eng1.query_range(REST_AUX[name].format(op="count"),
                                   *span)[0]
            mag = np.maximum(np.abs(mx.values), np.abs(mn.values))
            bound = 2 * gamma * cnt.values * mag
            if not np.all(np.abs(a.values - c.values) <= bound):
                raise AssertionError(f"{name} past the matrix-product bound")
            # the limit from readings: sum|x| is the sum itself where no
            # member is negative, else at most count * max|x|
            abs_sum = np.where(mn.values >= 0, np.abs(c.values),
                               cnt.values * mag)
            limit = MATMUL_READ_K * np.sqrt(n) * U * abs_sum
            gap = np.abs(a.values - c.values)
            read[name] = float(np.max(np.where(c.present, gap / np.maximum(
                limit, 1e-300), 0)))
            if not np.all(gap <= limit):
                raise AssertionError(f"{name} past the read limit "
                                     f"{MATMUL_READ_K} sqrt(n) u sum|x|")
            continue
        # e and g_instant: quantiles of matrix-product bucket sums. The
        # sums on the card stay within their bound of the CPU's (checked
        # here on the inner sum), and the quantile moves at most as far as
        # those sums can move it (quantile_gap_bound)
        inner = "sum by (le, svc) (rate(hist_bucket[1m]))"
        if span is None:
            card = engines["single"].query_instant(inner, HIST_SPAN[1])[0]
            ref_in = cpu.query_instant(inner, HIST_SPAN[1])[0]
            n = args.hist_pods * len(HIST_LES)   # the generic engine's S
            mags = engines["single"].query_instant(
                "max by (le, svc) (rate(hist_bucket[1m]))", HIST_SPAN[1])[0]
            cnts = engines["single"].query_instant(
                "count by (le, svc) (rate(hist_bucket[1m]))", HIST_SPAN[1])[0]
            u = 2.0 ** -53      # float64 vectors in the generic engine
        else:
            card = engines["single"].query_range(inner, *span)[0]
            ref_in = cpu.query_range(inner, *span)[0]
            n = 1 << max(3, (args.hist_pods * len(HIST_LES) - 1).bit_length())
            mags = engines["single"].query_range(
                "max by (le, svc) (rate(hist_bucket[1m]))", *span)[0]
            cnts = engines["single"].query_range(
                "count by (le, svc) (rate(hist_bucket[1m]))", *span)[0]
            u = U
        gamma = n * u / (1 - n * u)

        def by_label(v):
            return {(lab["svc"], lab["le"]): (v.values[i], v.present[i])
                    for i, lab in enumerate(v.labels)}

        card, ref_in = by_label(card), by_label(ref_in)
        mags, cnts = by_label(mags), by_label(cnts)
        sum_bound = {k: 2 * gamma * cnts[k][0] * np.abs(mags[k][0])
                     for k in ref_in}
        for k, (want, _) in ref_in.items():
            if not np.all(np.abs(card[k][0] - want) <= sum_bound[k]):
                raise AssertionError(f"{name}: bucket sums past the "
                                     "matrix-product bound")
        le_vals = np.asarray([float(x.replace("+Inf", "inf"))
                              for x in HIST_LES])
        for gi, lab in enumerate(c.labels):
            keys = [(lab["svc"], le) for le in HIST_LES]
            gap = quantile_gap_bound(
                np.stack([ref_in[k][0] for k in keys]), le_vals, 0.9,
                np.stack([sum_bound[k] for k in keys]).max(axis=0))
            d = np.abs(a.values[gi] - c.values[gi])
            if not np.all(d <= gap + 4 * np.spacing(
                    np.abs(c.values[gi]).astype(np.float32))):
                raise AssertionError(f"{name}: quantile past its bound")

    # ---- G at query f's shape ------------------------------------------
    v, members = store["sum"][0]
    exact = gr.grouped_block_reduce(v, members, "sum")
    plain = gr.grouped_block_reduce_plain(v, members, "sum")
    torch.cuda.synchronize()
    if not torch.equal(exact.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError("G at f's shape differs from its plain version")
    f_launch = stats["single"]["f"]["launches_per_warm"][
        "grouped_block_reduce"]
    dev_ms = device_ms_per_launch(
        {"ours": stats["single"]["f"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<float, 0>"))
    live = members.perm[:int(members.ptr[-1])].long()
    nseg = members.gb * members.blocks
    seg = (torch.repeat_interleave(
        torch.arange(nseg, device=dev),
        (members.ptr[1:] - members.ptr[:-1]).long()))
    nbytes = 8 * int(members.ptr[-1]) + 4 * (nseg + 1) + 4 * nseg
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    g_row = {
        "f64_at_h": g_f64_row(dev, gr, store, stats),
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(v, members,
                                                             "sum")),
        "device_ms_per_launch": dev_ms,
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, device=dev).index_add_(0, seg, v[live])),
        "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
        "share_of_bound": bound / dev_ms if dev_ms else None,
        "launches_per_warm_f": f_launch,
        "max_abs_err": float(torch.nan_to_num(
            (exact.double() - plain.double()).abs(), nan=0.0).max()),
        "shape": {"rows": v.numel(), "blocks": members.blocks,
                  "gb": members.gb, **segment_stats(members)},
    }
    # ---- K2 at query c's shape ------------------------------------------
    # its count of 1 M series (padded to 2^20, the padding not listed)
    # into 33 groups over 8 steps; int32 on random words of that shape
    arr_c, fm_c = store["k2"]
    words = torch.randint(-2**31, 2**31 - 1, tuple(arr_c.shape),
                          generator=torch.Generator(device=dev).manual_seed(
                              args.seed), device=dev, dtype=torch.int32)
    k2_row = {
        **k2_measure(dev, rf, arr_c, words, fm_c, add_ns, plain_reps=3),
        "launches_per_warm_c": stats["single"]["c"]["launches_per_warm"][
            "blocked_fold_sum"],
        "device_ms_per_launch_in_c": device_ms_per_launch(
            {"ours": stats["single"]["c"]["ours"]}, is_seed_kernel),
        "c_device_ms": stats["single"]["c"]["device_ms"],
    }
    emit({"phase": "promql_rest", "seconds": seconds,
          "rows_written": written, "hist_series": args.hist_pods * len(
              HIST_LES),
          "engines": stats, "launches": launches,
          "checks": {"engines_identical": True, "exact_equal_cpu": True,
                     "matmul_max_rel_diff_vs_cpu": rel,
                     "matmul_gap_over_read_limit": read,
                     "tf32_probe": tf32_probe(dev, s_pad),
                     "h_without_x64": h32_note},
          "g_at_f": g_row, "k2_at_c": k2_row,
          "phase_seconds": time.perf_counter() - t_phase})
    for k in ("grouped_block_reduce", "ring_pext_fused"):
        if not launches.get(k):
            raise AssertionError(f"{k} never launched in phase promql_rest")
    return launches, g_row, k2_row


def g_f64_row(dev, gr, store, stats):
    """G's float64 sum form at query h's shape (the generic engine's
    instant sum by (le, pod)): kernel against its plain version bit for
    bit, timed beside index_add_ and its bound."""
    v, members = store[("sum", "float64")][0]
    exact = gr.grouped_block_reduce(v, members, "sum")
    plain = gr.grouped_block_reduce_plain(v, members, "sum")
    torch.cuda.synchronize()
    if not torch.equal(exact.view(torch.int64), plain.view(torch.int64)):
        raise AssertionError("G float64 at h's shape differs from its plain "
                             "version")
    live = members.perm[:int(members.ptr[-1])].long()
    nseg = members.gb * members.blocks
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=dev),
        (members.ptr[1:] - members.ptr[:-1]).long())
    # 8 bytes a value and 4 a member index read, the pointers read, 8
    # bytes a segment written; one float64 add a live row
    nbytes = 12 * int(members.ptr[-1]) + 4 * (nseg + 1) + 8 * nseg
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = int(members.ptr[-1]) / F64_OPS_PER_S * 1e3
    dev_ms = device_ms_per_launch(
        {"ours": stats["single"]["h"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<double, 0>"))
    return {
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "device_ms_per_launch": dev_ms,
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, dtype=torch.float64, device=dev).index_add_(
                0, seg, v[live])),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": nbytes,
        "launches_per_warm_h": stats["single"]["h"]["launches_per_warm"][
            "grouped_block_reduce"],
        "max_abs_err": float(torch.nan_to_num(
            (exact - plain).abs(), nan=0.0).max()),
        "shape": {"rows": v.numel(), "blocks": members.blocks,
                  "gb": members.gb, **segment_stats(members)}}


def tf32_probe(dev, s_pad):
    """Whether the main path's group product can tell full float32 from
    TF32, at query a's shape (32 groups over s_pad series, eight step
    columns). Column "exact": 1000 members a group hold 1 + 2^-13 and the
    rest 0, so every partial sum is a float32 and any full-float32 order
    gives the exact sum; TF32 keeps 10 bits of each input and drops the
    2^-13. Column "uniform": values in [0.5, 1.5), as a rate over a last
    value. Returns each product's largest gap to the float64 sum, relative
    to the sum, and the read limit's relative size there."""
    from greptimedb_tpu_torch.ops.promql import _group_matmul

    g, j = 32, 8
    gid = torch.arange(s_pad, device=dev) % g
    onehot_t = (gid[None, :] == torch.arange(g, device=dev)[:, None]).float()
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.zeros((s_pad, j), device=dev)
    x[:g * 1000, :j // 2] = 1 + 2.0 ** -13
    x[:, j // 2:] = 0.5 + torch.rand((s_pad, j // 2), device=dev,
                                     generator=gen)
    want = onehot_t.double() @ x.double()
    full = _group_matmul(x, onehot_t)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = torch.matmul(onehot_t, x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    def gap(got, cols):
        return float(((got.double() - want).abs() / want.abs())[:, cols]
                     .max())

    exact, uniform = slice(0, j // 2), slice(j // 2, j)
    out = {"full_f32": {"exact": gap(full, exact),
                        "uniform": gap(full, uniform)},
           "tf32": {"exact": gap(tf32, exact), "uniform": gap(tf32, uniform)},
           "read_limit_rel": MATMUL_READ_K * float(np.sqrt(s_pad)) * U}
    if out["full_f32"]["exact"] != 0.0:
        raise AssertionError("the full-float32 group product is not exact "
                             "on exactly summable data")
    if out["tf32"]["exact"] == 0.0:
        raise AssertionError("the TF32 probe did not round")
    return out


SQL_Q2_OPS = ["count", "sum", "min", "max", "avg", "stddev_samp",
              "first_value", "last_value"]


def sql_suite(hosts, hours, regions):
    """bench.py's TSBS RANGE suite (bench.py:2131-2201: the headline and
    the nine device shapes) at a table of `hosts` x `hours`, and Q2 as
    SQL: (name, sql, rows bench.py wants at that size, disjoint-window
    mean columns)."""
    end_ms = hours * HOUR_MS
    hosts8 = ", ".join(f"'host_{i}'" for i in range(8))

    def items(op, rng, fields):
        return ", ".join(f"{op}({f}) RANGE '{rng}'" for f in fields)

    means = [f"avg({f}) RANGE '1h'" for f in FIELDS]
    return [
        ("double_groupby_all", f"SELECT ts, hostname, "
         f"{items('avg', '1h', FIELDS)} FROM cpu ALIGN '1h' BY (hostname)",
         hosts * hours, means),
        ("lastpoint", "SELECT ts, hostname, last_value(usage_user) RANGE "
         "'12h' FROM cpu ALIGN '12h' TO '1970-01-01 00:00:00' BY (hostname)",
         hosts * -(-hours // 12), ()),
        ("groupby_orderby_limit", "SELECT ts, max(usage_user) RANGE '1m' "
         f"FROM cpu WHERE ts < {end_ms - HOUR_MS} ALIGN '1m' BY () "
         "ORDER BY ts DESC LIMIT 5", min(5, (hours - 1) * 60), ()),
        ("single_groupby_1_1_1", "SELECT ts, max(usage_user) RANGE '1m' "
         f"FROM cpu WHERE hostname = 'host_17' AND ts >= {end_ms - HOUR_MS} "
         f"AND ts < {end_ms} ALIGN '1m' BY (hostname)", 60, ()),
        ("single_groupby_1_1_12", "SELECT ts, max(usage_user) RANGE '1m' "
         "FROM cpu WHERE hostname = 'host_17' ALIGN '1m' BY (hostname)",
         hours * 60, ()),
        ("single_groupby_5_8_1", f"SELECT ts, hostname, "
         f"{items('max', '1m', FIELDS[:5])} FROM cpu WHERE hostname IN "
         f"({hosts8}) AND ts >= {end_ms - HOUR_MS} AND ts < {end_ms} "
         "ALIGN '1m' BY (hostname)", 8 * 60, ()),
        ("cpu_max_all_1", f"SELECT ts, {items('max', '1h', FIELDS)} FROM cpu "
         "WHERE hostname = 'host_42' ALIGN '1h' BY (hostname) LIMIT 8",
         min(8, hours), ()),
        ("cpu_max_all_8", f"SELECT ts, hostname, "
         f"{items('max', '1h', FIELDS)} FROM cpu WHERE hostname IN "
         f"({hosts8}) AND ts < {8 * HOUR_MS} ALIGN '1h' BY (hostname)",
         8 * min(8, hours), ()),
        ("double_groupby_1", "SELECT ts, hostname, avg(usage_user) RANGE "
         "'1h' FROM cpu ALIGN '1h' BY (hostname)", hosts * hours,
         means[:1]),
        ("double_groupby_5", f"SELECT ts, hostname, "
         f"{items('avg', '1h', FIELDS[:5])} FROM cpu ALIGN '1h' "
         "BY (hostname)", hosts * hours, means[:5]),
        ("q2_by_region", "SELECT ts, region, " + ", ".join(
            f"{op}(usage_user) RANGE '2h'" for op in SQL_Q2_OPS)
         + " FROM cpu ALIGN '1h' BY (region)", regions * (hours + 1), ()),
    ]


def sql_phase(args, dev, slice_out, mesh_out):
    """Phase 8 (see the module docstring). Returns the phase's launch
    counts, those of the hop-ring engine alone, and per kernel the
    profiler's device time per launch on the warm SQL Q2 (K2's seed and
    fold_cont on the hop ring, the fused ring on the default ring)."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf

    t_phase = time.perf_counter()
    mesh_engines = mesh_out["engines"]
    # (table's phase, engine) -> (table, query engine, ring form). Each
    # Instance runs on the query engine that answered the plan-built
    # Q1/Q2 of its phase, so its grid is built already (cold is the SQL
    # shape's state growth); the hop ring runs on the ring engine's grid.
    runs = {
        ("slice", "single"): (slice_out, slice_out["engine"], "fused"),
        ("mesh", "single"): (mesh_out, mesh_engines["single"], "fused"),
        ("mesh", "fused"): (mesh_out, mesh_engines["ring"], "fused"),
        ("mesh", "hops"): (mesh_out, mesh_engines["ring"], "hops"),
        ("mesh", "gather"): (mesh_out, mesh_engines["gather"], "fused"),
    }
    zero_counts(rf, mg)
    results, stats, run_launches = {}, {}, {}
    insts = {}
    for (tname, ename), (tab, engine, form) in runs.items():
        before_run = counts(rf, mg)
        inst = insts[tname, ename] = Instance(device=dev, mesh=engine.mesh,
                                              mesh_opts=engine.mesh_opts)
        inst.query_engine = engine
        inst.catalog.register(tab["table"])
        suite = sql_suite(tab["hosts"], tab["hours"], tab["regions"])
        per_shape = {}
        with ring_form(form):
            for name, sql, want_rows, _ in suite:
                t = time.perf_counter()
                res = inst.sql(sql)
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                eng = inst.query_engine
                if eng.last_exec_path != "device":
                    raise AssertionError(f"{name} ran {eng.last_exec_path}")
                if res.num_rows != want_rows:
                    raise AssertionError(f"{tname} {ename} {name}: "
                                         f"{res.num_rows} rows, bench.py "
                                         f"wants {want_rows}")
                results[tname, ename, name] = res
                times = []
                before = counts(rf, mg)
                for _ in range(3):
                    t = time.perf_counter()
                    inst.sql(sql)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                after = counts(rf, mg)
                prof = profiled(lambda: inst.sql(sql))
                info = dict(eng.last_range)
                per_shape[name] = {
                    "cold_s": cold, "warm_median_s": float(np.median(times)),
                    "device_ms": prof["device_ms"],
                    "idle_share": prof["idle_share"],
                    "launches_per_warm": {
                        k: (after[k] - before[k]) / 3 for k in after
                        if after[k] > before[k]},
                    "folds": info["comm_bytes"] > 0, "program":
                    info["program"], "ring_form": info["ring_form"],
                    "ours": prof["ours"]}
        stats[f"{tname}_{ename}"] = per_shape
        after_run = counts(rf, mg)
        run_launches[f"{tname}_{ename}"] = {
            k: after_run[k] - before_run[k] for k in after_run
            if after_run[k] > before_run[k]}
    launches = counts(rf, mg)

    # ---- checks -------------------------------------------------------
    w1 = HOUR_MS // STEP_MS
    for tname, out in (("slice", slice_out), ("mesh", mesh_out)):
        # SQL Q1/Q2 against the plan-built Q1/Q2 of the same table, one
        # device (the mesh engines are held to one device below)
        compare_engines(f"{tname} SQL Q1", out["q1"],
                        results[tname, "single", "double_groupby_all"], w1,
                        names=False)
        compare_engines(f"{tname} SQL Q2", out["q2"],
                        results[tname, "single", "q2_by_region"], w1,
                        names=False)
    suite = sql_suite(mesh_out["hosts"], mesh_out["hours"],
                      mesh_out["regions"])
    checks = {}
    for name, _, _, means in suite:
        ref = results["mesh", "single", name]
        worst = 0.0
        for ename in ("fused", "hops", "gather"):
            _, rel = compare_engines(f"mesh {ename} {name}", ref,
                                     results["mesh", ename, name], w1,
                                     bounded=set(means))
            worst = max(worst, rel)
            st = stats[f"mesh_{ename}"][name]
            want_prog = ("sharded_gather" if ename == "gather"
                         else "sharded_ring")
            if st["program"] != want_prog or (
                    ename != "gather" and st["ring_form"] != ename):
                raise AssertionError(f"mesh {ename} {name} ran {st}")
            warm = st["launches_per_warm"]
            launched = warm.get("ring_fold_fused", 0)
            if ename == "fused" and st["folds"] and launched < 1:
                raise AssertionError(f"{name}: the fused ring never "
                                     f"launched on a folding query")
            if (ename != "fused" or not st["folds"]) and launched:
                raise AssertionError(f"{name}: the fused ring launched on "
                                     f"the {ename} engine")
            # the one-ring forms only where the shards share the card's
            # fused ring, the hop combines only on the hop ring
            for k in ONE_RING_KERNELS if ename != "fused" else ():
                if warm.get(k):
                    raise AssertionError(f"{name}: {k} on the {ename} "
                                         f"engine")
            for k in HOP_KERNELS if ename != "hops" else ():
                if warm.get(k):
                    raise AssertionError(f"{name}: {k} on the {ename} "
                                         f"engine")
        checks[name] = {"engines_identical": worst == 0.0,
                        "max_rel_diff_means": worst,
                        "folds": stats["mesh_fused"][name]["folds"]}
    if not any(c["folds"] for c in checks.values()):
        raise AssertionError("no suite query folded groups on the mesh")
    for k in ONE_RING_KERNELS + HOP_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} never launched in phase sql")
    # launches per warm SQL Q2 on four shards: one launch per ring on the
    # fused engine, ns - 1 hops per ring on the hop ring
    q2 = "q2_by_region"
    for ename, want in (("fused", {**Q2_RINGS, "extreme": 0,
                                   "onehot_add": 0}),
                        ("hops", {**Q2_HOPS, **{k: 0 for k in Q2_RINGS}}),
                        ("gather", {k: 0 for k in (*Q2_RINGS, *Q2_HOPS)})):
        warm = stats[f"mesh_{ename}"][q2]["launches_per_warm"]
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm SQL Q2 on the {ename} engine, "
                                     f"not {n}")

    # warm SQL Q2 of the two ring forms on the same grid, one after the
    # other in turn so both see the same host (after the main-path counts
    # were read)
    q2_sql = next(sql for name, sql, _, _ in suite if name == q2)
    walls = {"fused": [], "hops": []}
    for _ in range(Q2_WALL_REPS):
        for form in walls:
            with ring_form(form):
                t = time.perf_counter()
                insts["mesh", form].sql(q2_sql)
                torch.cuda.synchronize()
                walls[form].append((time.perf_counter() - t) * 1e3)
    q2_walls = {form: {"median_ms": float(np.median(w)),
                       "min_ms": float(np.min(w)), "reps": len(w)}
                for form, w in walls.items()}
    per_launch = {
        "ring_fold_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]},
            walk("ring_fold_fused")),
        "blocked_fold_sum": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]}, is_seed_kernel),
        "fold_cont": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]}, walk("fold_cont")),
        "extreme": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]},
            lambda k: k.startswith("extreme_")),
        "onehot_add": device_ms_per_launch(
            {"ours": stats["mesh_hops"][q2]["ours"]},
            lambda k: k.startswith("onehot_add")),
        "ring_pext_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]},
            ring_combine(0, 1, 2, 3)),
        "ring_psum_onehot_fused": device_ms_per_launch(
            {"ours": stats["mesh_fused"][q2]["ours"]}, ring_combine(4)),
    }
    engine_q2 = {e: {"device_ms": stats[f"mesh_{e}"][q2]["device_ms"],
                     "idle_share": stats[f"mesh_{e}"][q2]["idle_share"],
                     "launches_per_warm": stats[f"mesh_{e}"][q2][
                         "launches_per_warm"]}
                 for e in ("single", "fused", "hops", "gather")}
    emit({"phase": "sql", "engines": stats, "checks": checks,
          "launches": launches, "launches_by_engine": run_launches,
          "device_ms_per_launch_q2": per_launch,
          "q2_by_engine": engine_q2,
          "q2_warm_wall_by_ring_form": q2_walls,
          "phase_seconds": time.perf_counter() - t_phase})
    return (launches, run_launches["mesh_hops"], per_launch,
            {e: v["launches_per_warm"] for e, v in engine_q2.items()})



# ---- phase 9: rows ----------------------------------------------------

# the GROUP BYs of the rows phase: bench.py:411-412's probe, the nine-op
# GROUP BY region (stddev_samp keeps it on one device: the row path's
# var/stddev do not shard), and the same without stddev_samp, which the
# mesh engines shard (the ring forms carry its extremes and winners)
GROUPBY_OPS = ("count(*), sum(usage_user), avg(usage_user), "
               "min(usage_user), max(usage_system), {}first_value("
               "usage_idle), last_value(usage_idle)")
GROUPBY_QUERIES = [
    ("hostname_avg", "SELECT hostname, avg(usage_user) FROM cpu "
     "GROUP BY hostname"),
    ("region_all", "SELECT region, " + GROUPBY_OPS.format(
        "stddev_samp(usage_user), ") + " FROM cpu GROUP BY region"),
    ("region_ring", "SELECT region, " + GROUPBY_OPS.format("")
     + " FROM cpu GROUP BY region"),
]
# per warm region_ring on four shards: 8 ring extremes (min, max, three
# winner stages each of first and last) and 2 ring one-hot sums; on the
# hop ring 3 hops each
GROUPBY_RINGS = {"ring_pext_fused": 8, "ring_psum_onehot_fused": 2}
GROUPBY_HOPS = {"extreme": 24, "onehot_add": 6}
GROUPED_KERNELS = ("grouped_block_reduce", "column_tree_sum")
HOST_CUT_MS = 3 * HOUR_MS     # the host RANGE shapes read the first 3 h


def host_shapes():
    """TSBS high-cpu-1 and high-cpu-all (bench.py:2202-2213) and the five
    RANGE shapes the device grid declines (a residual OR, a residual
    filter, an expression argument, a ts bound off a cell edge, NOT LIKE),
    those five cut to the first 3 hours."""
    cut = f"ts < {HOST_CUT_MS}"
    q2 = ", ".join(f"{op}(usage_user) RANGE '1h'" for op in (
        "count", "sum", "min", "max", "avg", "stddev_samp", "first_value",
        "last_value"))
    return [
        ("high_cpu_1", "SELECT ts, usage_user, usage_system FROM cpu "
         "WHERE usage_user > 90.0 AND hostname = 'host_17'"),
        ("high_cpu_all", "SELECT * FROM cpu WHERE usage_user > 90.0"),
        ("high_cpu_all_cached", "SELECT * FROM cpu WHERE usage_user > 90.0"),
        ("or_hosts", "SELECT ts, hostname, avg(usage_user) RANGE '1h' FROM "
         "cpu WHERE (hostname = 'host_3' OR hostname = 'host_4') AND "
         f"{cut} ALIGN '1h' BY (hostname)"),
        ("usage_filter", f"SELECT ts, region, {q2} FROM cpu WHERE "
         f"usage_user > 50 AND {cut} ALIGN '1h' BY (region)"),
        ("expression_arg", "SELECT ts, hostname, avg(usage_user + "
         f"usage_system) RANGE '1h' FROM cpu WHERE {cut} ALIGN '1h' "
         "BY (hostname)"),
        ("ts_off_edge", "SELECT ts, region, max(usage_user) RANGE '1h' FROM "
         f"cpu WHERE ts > 3600000 AND {cut} ALIGN '1h' BY (region)"),
        ("not_like", "SELECT ts, region, avg(usage_idle) RANGE '1h' FROM "
         f"cpu WHERE hostname NOT LIKE 'host_1%' AND {cut} ALIGN '1h' "
         "BY (region)"),
    ]


@contextlib.contextmanager
def capture_k2(rf, store):
    """Record the inputs of the first K2 call while this block is open;
    the real wrapper runs as it would, and its launch count is carried on
    the recorder while it stands in (as capture_grouped does)."""
    real = rf.blocked_fold_sum

    def k2(arr, fm):
        store.setdefault("k2", (arr, fm))
        return real(arr, fm)

    k2.launches = real.launches
    rf.blocked_fold_sum = k2
    try:
        yield
    finally:
        real.launches = k2.launches
        rf.blocked_fold_sum = real


@contextlib.contextmanager
def capture_grouped(gr, store):
    """Record the inputs of the first two calls of each form of G and of
    Gt, and of the first member build of each group count, while this
    block is open; the real wrappers run as they would. A wrapper counts
    its launches on the module attribute of its name, so each recorder
    carries the count while it stands in and hands it back after."""
    real = (gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members)

    def keep(key, item):
        calls = store.setdefault(key, [])
        if len(calls) < 2:
            calls.append(item)

    def g(v, members, form):
        keep(form if v.dtype != torch.float64 else (form, "float64"),
             (v, members))
        return real[0](v, members, form)

    def t(x):
        keep("tree", x)
        return real[1](x)

    def m(gid, mask, blocks, gb):
        keep(("members", gb), (gid, mask, blocks, gb))
        return real[2](gid, mask, blocks, gb)

    g.launches, t.launches = real[0].launches, real[1].launches
    gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members = g, t, m
    try:
        yield
    finally:
        real[0].launches, real[1].launches = g.launches, t.launches
        gr.grouped_block_reduce, gr.column_tree_sum, gr.group_members = real


def groupby_reference(table, key):
    """numpy over the scan: per key value (sorted) the row count and the
    float64 mean of usage_user."""
    rows = table.scan(["usage_user"]).rows
    vals = np.asarray(table.region.series.tag_values(key))[rows.sid]
    names, inv = np.unique(vals, return_inverse=True)
    cnt = np.bincount(inv)
    mean = np.bincount(inv, weights=rows.fields["usage_user"]) / cnt
    return names, cnt, mean


def check_groupby(name, res, ref):
    names, cnt, mean = ref
    key = np.asarray(res.cols[0].values, object)
    order = np.argsort(key)
    if res.num_rows != len(names) or not (key[order] == names).all():
        raise AssertionError(f"{name}: groups {res.num_rows} vs {len(names)}")
    avg = np.asarray(res.column("avg(usage_user)").values)[order]
    worst = float(np.max(np.abs(avg - mean) / np.abs(mean)))
    if worst > 1e-5:
        raise AssertionError(f"{name}: avg off the numpy mean by {worst}")
    if "count(*)" in res.names:
        got = np.asarray(res.column("count(*)").values)[order]
        if not np.array_equal(got, cnt):
            raise AssertionError(f"{name}: count(*) differs from bincount")
    return worst


def edge_members(dev, gr, rng, n, blocks, gb, layout="random"):
    """Edge inputs of G: NaNs of both signs, +-0.0, +-inf, an all-masked
    group and groups with no rows, padding rows (mask False, gid 0). Group
    ids are uniform ("random") or in series order ("runs": contiguous runs
    of 1, 31, 32, 33, 64, 65 and 4096+ rows, the padding after the live
    rows)."""
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    k = rng.choice(n, min(n, 64), replace=False)
    v[k] = np.resize(np.array(
        [0xFFC00001, 0x7FC00002, 0xFF800000, 0x7F800000, 0x80000000,
         0x00000000, 0x7FC00000, 0x80000000], np.uint32), len(k)).view(
        np.float32)
    mask = rng.random(n) > 0.15
    gid = rng.integers(0, max(gb - 2, 1), n).astype(np.int32)
    if layout == "runs":
        live = n - n // 7
        lens = rng.choice([1, 31, 32, 33, 64, 65, 4096], n)
        lens[lens == 4096] += rng.integers(0, 500, int((lens == 4096).sum()))
        runs = int(np.searchsorted(np.cumsum(lens), live)) + 1
        run_of = np.repeat(np.arange(runs), lens[:runs])[:live]
        gid[:live] = (run_of % max(gb - 2, 1)).astype(np.int32)
        mask[live:] = False
    if gb > 2:
        mask[gid == 1] = False
    gid[~mask] = 0
    return (torch.from_numpy(v).to(dev),
            gr.group_members(torch.from_numpy(gid).to(dev),
                             torch.from_numpy(mask).to(dev), blocks, gb))


def segment_stats(members):
    """Non-empty segments of a member order, their mean and largest row
    count: the regime the walk runs in."""
    lens = (members.ptr[1:] - members.ptr[:-1]).long()
    busy = lens[lens > 0]
    return {"segments": lens.numel(), "nonempty": busy.numel(),
            "mean_rows": float(busy.double().mean()) if busy.numel() else 0.0,
            "max_rows": int(busy.max()) if busy.numel() else 0}


def burst_ms(fn, reps=50) -> float:
    """Device time per call of a kernel that runs longer than its launch:
    CUDA events around `reps` back-to-back calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def scattered_members(dev, gr, seed):
    """G's sum form where one thread a segment is at home: 2^25 live rows
    with uniform random ids over 4096 groups, 256 row blocks (~32 rows a
    segment), values and ids made on the card from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, gb, blocks = 1 << 25, 4096, 256
    v = (torch.randn(n, device=dev, generator=g)
         * 10.0 ** torch.randint(-3, 4, (n,), device=dev, generator=g))
    gid = torch.randint(0, gb, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    return v, gid, gr.group_members(gid, mask, blocks, gb)


def grouped_kernel_rows(dev, gr, store, launches, per_launch):
    """G and Gt at the shapes the GROUP BYs gave them (the hostname probe's
    sums, the region query's extremes and int32 winner stages, its
    var/stddev mean) and G's sum form on scattered rows, held against
    their plain versions on the card and on edge inputs, bit for bit, and
    timed beside their bounds, plain versions and library calls."""
    errs = {}

    def exact(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what} differs from its plain version")
        diff = (got.double() - want.double()).abs()
        errs[what] = float(torch.nan_to_num(diff, nan=0.0).max())

    rng = np.random.default_rng(17)
    for layout in ("random", "runs"):
        for n, blocks, gb in ((100_003, 256, 64), (1 << 17, 65536, 16),
                              (50_000, 8, 1), (4097, 4096, 4),
                              (1 << 20, 256, 16)):
            v, members = edge_members(dev, gr, rng, n, blocks, gb, layout)
            for form in ("sum", "max", "min"):
                exact(f"G {form} edge {layout} {n}x{blocks}x{gb}",
                      gr.grouped_block_reduce(v, members, form),
                      gr.grouped_block_reduce_plain(v, members, form))
    # the main path's sections: the hostname probe's avg(usage_user) sums
    # (its second sum section; the first is the count), the region query's
    # min/max, and its stddev mean's column sum (the second tree: the
    # first is the count's)
    inputs = {"sum": store["sum"][1], "max": store["max"][0],
              "min": store["min"][0]}
    for form, (v, members) in inputs.items():
        exact(f"G {form}", gr.grouped_block_reduce(v, members, form),
              gr.grouped_block_reduce_plain(v, members, form))
    # the int32 extremes of last_value's and first_value's first stage
    for form in ("max", "min"):
        keys, members = store[form][1]
        if keys.dtype != torch.int32:
            raise AssertionError(f"G {form}: no int32 winner stage captured")
        exact(f"G {form} int32", gr.grouped_block_reduce(keys, members, form),
              gr.grouped_block_reduce_plain(keys, members, form))
    sv, sgid, sm = scattered_members(dev, gr, 23)
    exact("G sum scattered", gr.grouped_block_reduce(sv, sm, "sum"),
          gr.grouped_block_reduce_plain(sv, sm, "sum"))
    tree_x = store["tree"][1]
    exact("Gt", gr.column_tree_sum(tree_x), gr.column_tree_sum_plain(tree_x))
    x = (torch.randn(65536, 16, device=dev)
         * 10.0 ** torch.randint(-3, 4, (65536, 16), device=dev))
    exact("Gt edge", gr.column_tree_sum(x), gr.column_tree_sum_plain(x))

    def sum_bytes(members):
        nseg = members.gb * members.blocks
        return 8 * int(members.ptr[-1]) + 4 * (nseg + 1) + 4 * nseg

    def ext_bytes(members):
        return (8 * int(members.ptr[-1])
                + 4 * (members.gb * members.blocks + 1) + 4 * members.gb)

    def live_rows(members):
        # the library calls run over the live rows only (the padding
        # would pile onto one trash slot)
        return members.perm[:int(members.ptr[-1])].long()

    out = []
    # ---- G: the sum form at the hostname probe's shape and on scattered
    # rows, the extremes at the region query's
    v, members = inputs["sum"]
    gid, mask, blocks, gb = store["members", members.gb][0]
    n, nseg = v.numel(), members.gb * members.blocks
    per = -(-n // blocks)
    rows_live = live_rows(members)
    seg = (gid.long() * blocks + torch.arange(n, device=dev) // per)[
        rows_live]
    v_live = v[rows_live]
    sum_ms = per_launch.get("sum")
    bound = sum_bytes(members) / HBM_BYTES_PER_S * 1e3
    s_live = live_rows(sm)
    s_seg = (sgid.long() * sm.blocks + torch.arange(sm.n, device=dev)
             // -(-sm.n // sm.blocks))[s_live]
    s_bound = sum_bytes(sm) / HBM_BYTES_PER_S * 1e3
    key32 = gid.masked_fill(~mask, gb)
    key16 = key32.to(torch.int16)
    vx, mx = inputs["max"]
    gid_x = store["members", mx.gb][0][0]
    rx = live_rows(mx)
    keys, mk = store["max"][1]
    gid_k = store["members", mk.gb][0][0]
    rk = live_rows(mk)
    out.append({
        "name": "grouped_block_reduce", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "grouped_reduce.cu",
        "replaces": "greptimedb_tpu/query/reduce.py:250 pseg2 / :278 "
                    "segment_max (XLA, no Pallas kernel)",
        "launches": launches["grouped_block_reduce"],
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("G ")),
        "ms": cuda_ms(lambda: gr.grouped_block_reduce(v, members, "sum")),
        "host_ms": host_ms(lambda: gr.grouped_block_reduce(v, members,
                                                           "sum")),
        "device_ms_per_launch": sum_ms,
        "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(v, members,
                                                             "sum")),
        "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
            v, members, "sum"), reps=3, warm=1),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.zeros(
            nseg, device=dev).index_add_(0, seg, v_live)),
        "share_of_bound": bound / sum_ms if sum_ms else None,
        "shape": {"rows": n, "live_rows": int(members.ptr[-1]),
                  "blocks": blocks, "gb": gb, **segment_stats(members)},
        "bytes": sum_bytes(members),
        "members_ms": cuda_ms(lambda: gr.group_members(gid, mask, blocks,
                                                       gb), reps=5),
        "members_sort_ms": {
            "int16": cuda_ms(lambda: torch.sort(key16, stable=True), reps=5),
            "int32": cuda_ms(lambda: torch.sort(key32, stable=True),
                             reps=5)},
        "scattered": {
            "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(sv, sm,
                                                                 "sum")),
            "bound_ms": s_bound,
            "library_ms": cuda_ms(lambda: torch.zeros(
                sm.gb * sm.blocks, device=dev).index_add_(0, s_seg,
                                                         sv[s_live])),
            "shape": {"rows": sm.n, "live_rows": int(sm.ptr[-1]),
                      "blocks": sm.blocks, "gb": sm.gb,
                      **segment_stats(sm)},
            "bytes": sum_bytes(sm)},
        "max_form": {
            "ms": cuda_ms(lambda: gr.grouped_block_reduce(vx, mx, "max")),
            "device_ms_per_launch": per_launch.get("max"),
            "walk_ms_per_call": per_launch.get("max_walk"),
            "fold_ms_per_call": per_launch.get("max_fold"),
            "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
                vx, mx, "max"), reps=3, warm=1),
            "bound_ms": ext_bytes(mx) / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_ms(lambda: torch.full(
                (mx.gb,), -torch.inf, device=dev).scatter_reduce_(
                0, gid_x.long()[rx], vx[rx], "amax")),
            "shape": {"rows": vx.numel(), "live_rows": int(mx.ptr[-1]),
                      "blocks": mx.blocks, "gb": mx.gb,
                      **segment_stats(mx)},
            "bytes": ext_bytes(mx)},
        "int32_form": {
            "ms": cuda_ms(lambda: gr.grouped_block_reduce(keys, mk, "max")),
            "device_ms_per_launch": per_launch.get("int32"),
            "walk_ms_per_call": per_launch.get("int32_walk"),
            "fold_ms_per_call": per_launch.get("int32_fold"),
            "bound_ms": ext_bytes(mk) / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_ms(lambda: torch.full(
                (mk.gb,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                device=dev).scatter_reduce_(0, gid_k.long()[rk], keys[rk],
                                            "amax")),
            "shape": {"rows": keys.numel(), "live_rows": int(mk.ptr[-1]),
                      "blocks": mk.blocks, "gb": mk.gb},
            "bytes": ext_bytes(mk)},
        "design": "a warp a 32-segment chunk of one group, chunk-major, "
                  "one launch of a warp a chunk: a chunk holding a segment "
                  f"of >= {gr._WARP_ROWS} rows streams as one coalesced "
                  "range through a shared-memory stage (12 batches of 32 "
                  "rows, the next chunk's loads in flight while this one "
                  "folds in order), any other walks a lane a segment with "
                  "16 rows of loads in flight; max/min fold a chunk's "
                  "segments in a warp, then a group's chunks in a second "
                  "kernel; members by a stable torch.sort of int16 group "
                  "ids",
    })
    # ---- Gt at the var/stddev mean's shape
    rows_t, cols_t = tree_x.shape
    tree_bytes = 4 * rows_t * cols_t + 4 * cols_t
    out.append({
        "name": "column_tree_sum", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/kernels/csrc/"
                  "grouped_reduce.cu",
        "replaces": "greptimedb_tpu/query/reduce.py:274 jnp.sum(sp, axis=0)"
                    " (XLA, no Pallas kernel)",
        "launches": launches["column_tree_sum"],
        "max_abs_err": max(errs["Gt"], errs["Gt edge"]),
        "ms": cuda_ms(lambda: gr.column_tree_sum(tree_x)),
        "host_ms": host_ms(lambda: gr.column_tree_sum(tree_x)),
        "device_ms_per_launch": per_launch.get("tree"),
        "kernel_launches_per_call": per_launch.get("tree_launches"),
        "plain_ms": cuda_ms(lambda: gr.column_tree_sum_plain(tree_x)),
        "bound_ms": max(tree_bytes / HBM_BYTES_PER_S,
                        rows_t * cols_t / F32_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if tree_bytes / HBM_BYTES_PER_S
                     >= rows_t * cols_t / F32_OPS_PER_S else "operations"),
        "library_ms": cuda_ms(lambda: tree_x.sum(dim=0)),
        "shape": {"rows": rows_t, "cols": cols_t}, "bytes": tree_bytes,
        "design": "every level in one launch: a block a slab of 1024 rows "
                  "of a column tile (two levels in shared memory), the last "
                  "block of a tile to arrive runs the rest over the slab "
                  "sums",
    })
    return out


def per_call(ours, match, calls):
    """Profiler device ms of the kernels `match` selects over `calls`
    wrapper calls (None when either is missing)."""
    ms = sum(v["ms"] for k, v in ours.items() if match(k))
    return ms / calls if calls and ms else None


def rows_phase(args, dev, slice_out, mesh_out):
    """Phase 9 (see the module docstring). Returns the rows of G and Gt
    for the kernels line and every kernel's launches over the phase's main
    path."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.mesh import MeshOptions, make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * 4)
    runs = {
        ("slice", "single"): (slice_out, None, None, "fused"),
        ("mesh", "single"): (mesh_out, None, None, "fused"),
        ("mesh", "fused"): (mesh_out, mesh, None, "fused"),
        ("mesh", "hops"): (mesh_out, mesh, None, "hops"),
        ("mesh", "gather"): (mesh_out, mesh,
                             MeshOptions(pallas_kernels="off"), "fused"),
    }
    zero_counts(rf, mg)
    for k in GROUPED_KERNELS:
        getattr(gr, k).launches = 0
    store = {}
    results, stats, by_engine = {}, {}, {}

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS}}

    for (tname, ename), (tab, m, opts, form) in runs.items():
        inst = Instance(device=dev, mesh=m, mesh_opts=opts)
        inst.catalog.register(tab["table"])
        before_run = all_counts()
        per_query = {}
        capture = (capture_grouped(gr, store) if (tname, ename) == (
            "slice", "single") else contextlib.nullcontext())
        with ring_form(form), capture:
            for qname, sql in GROUPBY_QUERIES:
                if qname == "region_ring" and tname == "slice":
                    continue
                t = time.perf_counter()
                res = inst.sql(sql)
                torch.cuda.synchronize()
                cold = time.perf_counter() - t
                eng = inst.query_engine
                if eng.last_exec_path != "device":
                    raise AssertionError(f"{tname} {ename} {qname} ran "
                                         f"{eng.last_exec_path}")
                results[tname, ename, qname] = res
                times = []
                before = all_counts()
                for _ in range(3):
                    t = time.perf_counter()
                    inst.sql(sql)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                after = all_counts()
                prof = profiled(lambda: inst.sql(sql))
                # a profile that saw fewer of the port's kernels than the
                # counts saw launch a warm call is taken once more: now
                # and then the profiler returns a session without its
                # device records (the Gt check below reads this profile)
                counted = sum(after[k] - before[k] for k in after) / 3
                if sum(v["calls"] for v in prof["ours"].values()) < counted:
                    prof = profiled(lambda: inst.sql(sql))
                per_query[qname] = {
                    "cold_s": cold, "warm_median_s": float(np.median(times)),
                    "device_ms": prof["device_ms"],
                    "copy_ms": prof["copy_ms"],
                    "idle_share": prof["idle_share"],
                    "launches_per_warm": {
                        k: (after[k] - before[k]) / 3 for k in after
                        if after[k] > before[k]},
                    "program": dict(eng.last_reduce), "top": prof["top"],
                    "ours": prof["ours"]}
        stats[f"{tname}_{ename}"] = per_query
        after_run = all_counts()
        by_engine[f"{tname}_{ename}"] = {
            k: after_run[k] - before_run[k] for k in after_run
            if after_run[k] > before_run[k]}
    launches = all_counts()

    # ---- checks -------------------------------------------------------
    checks = {}
    for tname, tab in (("slice", slice_out), ("mesh", mesh_out)):
        table = tab["table"]
        for qname, key in (("hostname_avg", "hostname"),
                           ("region_all", "region")):
            checks[f"{tname}_{qname}_max_rel_vs_numpy"] = check_groupby(
                f"{tname} {qname}", results[tname, "single", qname],
                groupby_reference(table, key))
    for qname, _ in GROUPBY_QUERIES:
        ref = results["mesh", "single", qname]
        for ename in ("fused", "hops", "gather"):
            compare_engines(f"rows mesh {ename} {qname}", ref,
                            results["mesh", ename, qname], 1)
            prog = stats[f"mesh_{ename}"][qname]["program"]
            want = ("single" if qname == "region_all" else
                    "sharded_gather" if ename == "gather" else
                    "sharded_ring")
            if prog["program"] != want or (
                    want == "sharded_ring" and prog["ring_form"] != ename):
                raise AssertionError(f"rows mesh {ename} {qname} ran {prog}")
    for eng_name, got in by_engine.items():
        if not got.get("grouped_block_reduce"):
            raise AssertionError(f"G never launched on {eng_name}")
    for ename, want in (
            ("fused", {**GROUPBY_RINGS, "extreme": 0, "onehot_add": 0}),
            ("hops", {**GROUPBY_HOPS, **{k: 0 for k in GROUPBY_RINGS}}),
            ("gather", {k: 0 for k in (*GROUPBY_RINGS, *GROUPBY_HOPS)})):
        warm = stats[f"mesh_{ename}"]["region_ring"]["launches_per_warm"]
        for k, n in want.items():
            if warm.get(k, 0) != n:
                raise AssertionError(f"{k}: {warm.get(k, 0)} launches per "
                                     f"warm region_ring GROUP BY on the "
                                     f"{ename} engine, not {n}")

    # ---- the host paths on the slice table ----------------------------
    table = slice_out["table"]
    host_inst = Instance(device=dev)
    host_inst.catalog.register(table)
    host = {}
    hits0 = table.region.scan_cache_hits
    for name, sql in host_shapes():
        hits = table.region.scan_cache_hits
        t = time.perf_counter()
        res = host_inst.sql(sql)
        wall = time.perf_counter() - t
        if host_inst.query_engine.last_exec_path != "host":
            raise AssertionError(f"{name} ran "
                                 f"{host_inst.query_engine.last_exec_path}")
        if res.num_rows == 0:
            raise AssertionError(f"{name} returned no rows")
        host[name] = {"wall_s": wall, "rows": res.num_rows,
                      "scan_cache_hit": table.region.scan_cache_hits > hits}
        if name.startswith("high_cpu"):
            host[name]["rows_vs_numpy"] = check_high_cpu(table, name, res)
    if not host["high_cpu_all_cached"]["scan_cache_hit"]:
        raise AssertionError("the second high-cpu-all missed the merged-"
                             "scan cache")
    # the OR of two hosts on the host path against the same hosts as a
    # matcher on the device grid
    dev_or = host_inst.sql(host_shapes()[3][1].replace(
        "(hostname = 'host_3' OR hostname = 'host_4')",
        "hostname IN ('host_3', 'host_4')"))
    if host_inst.query_engine.last_exec_path != "device":
        raise AssertionError("the IN twin of or_hosts left the device grid")
    host_or = host_inst.sql(host_shapes()[3][1])
    a = np.asarray(host_or.cols[2].values)
    b = np.asarray(dev_or.cols[2].values)
    if host_or.num_rows != dev_or.num_rows or not np.allclose(
            a, b, rtol=1e-5, atol=0):
        raise AssertionError("or_hosts on the host differs from the grid")
    host["scan_cache_hits"] = table.region.scan_cache_hits - hits0

    # ---- kernels G and Gt --------------------------------------------
    # device time per wrapper call on the warm profiled GROUP BYs of the
    # slice table: a max/min call is a segment walk and a group fold (the
    # float32 extremes of min/max, the int32 ones of the winner stages),
    # each also apart; a Gt call is one launch
    slice_stats = stats["slice_single"]
    region = slice_stats["region_all"]
    ours = region["ours"]
    per_launch = {"sum": device_ms_per_launch(
        {"ours": slice_stats["hostname_avg"]["ours"]},
        lambda k: k.startswith("segment_walk_kernel<float, 0>"))}
    for t, key in (("float", "max"), ("int", "int32")):
        walks = tuple(f"segment_walk_kernel<{t}, {f}>" for f in (1, 2))
        fold = f"group_fold_kernel<{t}"
        calls = sum(v["calls"] for k, v in ours.items()
                    if k.startswith(walks))
        per_launch[key] = per_call(
            ours, lambda k: k.startswith((*walks, fold)), calls)
        per_launch[f"{key}_walk"] = per_call(
            ours, lambda k: k.startswith(walks), calls)
        per_launch[f"{key}_fold"] = per_call(
            ours, lambda k: k.startswith(fold), calls)
    tree_calls = region["launches_per_warm"].get("column_tree_sum")
    tree_kernels = sum(v["calls"] for k, v in ours.items()
                       if k.startswith("column_tree_kernel"))
    per_launch["tree"] = per_call(
        ours, lambda k: k.startswith("column_tree_kernel"), tree_calls)
    # the region query's var/stddev mean makes Gt calls: none counted, or
    # none profiled, is a failed measurement
    if not tree_calls or tree_kernels != tree_calls:
        raise AssertionError(f"Gt: {tree_kernels} kernels profiled over "
                             f"{tree_calls} calls, not one a call")
    per_launch["tree_launches"] = tree_kernels / tree_calls
    t = time.perf_counter()
    rows = grouped_kernel_rows(dev, gr, store, launches, per_launch)
    emit({"phase": "rows", "engines": stats, "checks": checks,
          "launches": launches, "launches_by_engine": by_engine,
          "host": host, "host_cut_ms": HOST_CUT_MS,
          "kernel_seconds": time.perf_counter() - t,
          "phase_seconds": time.perf_counter() - t_phase})
    return rows, launches, {
        e: stats[f"mesh_{e}"]["region_ring"]["launches_per_warm"]
        for e in ("fused", "hops")}


# ---- phase 11: durable ------------------------------------------------

# the child of the crash check: reopen the durable catalog, write one more
# 15-minute run past the data, acknowledge it, and die before any flush
CRASH_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from chip_smoke import durable_catalog, crash_batch
eng, cat = durable_catalog(sys.argv[2], sys.argv[3])
table = cat.table("public", "cpu")
tags, ts, fields = crash_batch(int(sys.argv[4]), int(sys.argv[5]),
                               int(sys.argv[6]))
table.write(tags, ts, fields)
print("ACK", len(ts), flush=True)
os._exit(0)
"""


def durable_catalog(root, device):
    """A storage engine over `root` (WAL on, wal_sync at its default, merges
    verified against the host merge) and the catalog on it."""
    from greptimedb_tpu_torch.catalog.manager import CatalogManager
    from greptimedb_tpu_torch.storage.compaction import CompactionOptions
    from greptimedb_tpu_torch.storage.engine import EngineConfig, TsdbEngine

    eng = TsdbEngine(EngineConfig(
        data_root=root, enable_background=False,
        compaction=CompactionOptions(verify_device_merge=True)),
        device=device)
    return eng, CatalogManager(eng)


def crash_batch(seed, hosts, hours):
    """The crash child's write: a 15-minute run of every host right after
    the data's last hour, values from `seed`."""
    rng = np.random.default_rng(seed + 1)
    per_run = HOUR_MS // STEP_MS // 4
    t0 = hours * (HOUR_MS // STEP_MS)
    names = np.array([f"host_{i}" for i in range(hosts)], object)
    ts = np.tile(np.arange(t0, t0 + per_run, dtype=np.int64) * STEP_MS,
                 hosts)
    hi = np.repeat(np.arange(hosts), per_run)
    fields = {f: rng.random(len(ts)) for f in FIELDS}
    return {"hostname": names[hi], "region": np.full(len(ts), "crash",
                                                     object)}, ts, fields


def same_scan(name, want, got):
    """Two full scans bit for bit: sids, timestamps, sequences, ops, every
    field's bits and validity (a validity of None reads as all valid)."""
    if len(want) != len(got):
        raise AssertionError(f"{name}: {len(got)} rows, not {len(want)}")
    for k in ("sid", "ts", "seq", "op"):
        if not np.array_equal(getattr(want, k), getattr(got, k)):
            raise AssertionError(f"{name}: column {k} differs")
    for f in FIELDS:
        if not np.array_equal(want.fields[f].view(np.uint64),
                              got.fields[f].view(np.uint64)):
            raise AssertionError(f"{name}: field {f} differs")
        va = (want.field_valid or {}).get(f)
        vb = (got.field_valid or {}).get(f)
        va = np.ones(len(want), bool) if va is None else va
        vb = np.ones(len(got), bool) if vb is None else vb
        if not np.array_equal(va, vb):
            raise AssertionError(f"{name}: validity of {f} differs")


def durable_phase(args, dev, slice_out, P):
    """Phase 11 (see the module docstring). Returns K1's and K2's launches
    over the phase's main path."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.datatypes.schema import Schema
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import device_range as DR
    from greptimedb_tpu_torch.query.executor import QueryEngine
    from greptimedb_tpu_torch.storage import recovery as R
    from greptimedb_tpu_torch.storage.device_merge import (
        DEFAULT_KERNEL_MIN_ROWS,
    )
    from greptimedb_tpu_torch.storage.page_cache import global_page_cache

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    out = {"guarantee": "wal_sync=False: an acknowledged write survives a "
                        "process crash (the WAL is written and flushed to "
                        "the OS before the write returns), not a power "
                        "loss (no fsync)"}
    q1, q2 = make_plans(P)
    mg.gather_planes.launches = 0
    rf.blocked_fold_sum.launches = 0
    try:
        eng, cat = durable_catalog(root, dev)
        table = cat.create_table(
            "public", "cpu", Schema.of("ts", ["hostname", "region"],
                                       dict.fromkeys(FIELDS, np.float64)),
            options={"compaction_trigger_files": 2,
                     "compaction_window_ms": HOUR_MS,
                     "memtable_window_ms": HOUR_MS})
        # ---- ingest: phase 2's writes, each hour's four runs as one
        # batch (bench.py's hourly WAL batches), then its re-delivery
        # and tombstone runs; a flush after each write
        rng = np.random.default_rng(args.seed)
        hosts = np.array([f"host_{i}" for i in range(args.hosts)])
        region_of = np.array(AWS_REGIONS)[rng.integers(
            0, len(AWS_REGIONS), args.hosts)]
        written, write_s, flush_s, flushes = 0, 0.0, 0.0, 0
        for runs in tsbs_hours(rng, hosts, region_of, args.hours):
            puts = runs[:4]
            hourly = ("put",
                      {k: np.concatenate([r[1][k] for r in puts])
                       for k in puts[0][1]},
                      np.concatenate([r[2] for r in puts]),
                      {f: np.concatenate([r[3][f] for r in puts])
                       for f in FIELDS})
            for run in (hourly, runs[4], runs[5]):
                t = time.perf_counter()
                written += write_run(table, run)
                write_s += time.perf_counter() - t
                t = time.perf_counter()
                table.flush()
                flush_s += time.perf_counter() - t
                flushes += 1
        out["ingest"] = {"rows": written, "write_s": write_s,
                         "rows_per_s_wal": written / write_s,
                         "flushes": flushes, "flush_s": flush_s,
                         "flush_s_each": flush_s / flushes}
        # ---- compaction: every window's three files merge on the card
        region = table.region
        k1 = mg.gather_planes.launches
        t = time.perf_counter()
        if not table.compact():
            raise AssertionError("durable compaction merged nothing")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t
        k1 = mg.gather_planes.launches - k1
        big = [p for p, n in zip(region.merge_paths, region.merge_rows_in)
               if n >= DEFAULT_KERNEL_MIN_ROWS]
        if not big or set(big) != {"fused"} or k1 < len(big):
            raise AssertionError(f"durable merges {region.merge_paths} "
                                 f"{region.merge_rows_in}: K1 launched {k1}"
                                 f" times for {len(big)} merges of "
                                 f">= {DEFAULT_KERNEL_MIN_ROWS} rows")
        out["compaction"] = {
            "seconds": compact_s, "merges": len(region.merge_paths),
            "seconds_per_merge": compact_s / len(region.merge_paths),
            "rows_in": region.merge_rows_in, "paths": region.merge_paths,
            "k1_launches": k1, "k1_launches_per_merge": k1 / len(big),
            "ssts_after": len(region.manifest.state.ssts)}
        want = slice_out["table"].scan(FIELDS).rows
        t = time.perf_counter()
        same_scan("after compaction", want, table.scan(FIELDS).rows)
        out["scan_after_compaction_s"] = time.perf_counter() - t
        eng.close()

        # ---- reopen: manifest load, WAL replay, SST restore
        global_page_cache.clear()
        t = time.perf_counter()
        eng, cat = durable_catalog(root, dev)
        open_ms = (time.perf_counter() - t) * 1e3
        table = cat.table("public", "cpu")
        region = table.region
        restore = {}
        for depth in (0, 4):
            global_page_cache.clear()
            st = R.restore_region_ssts(region, prefetch_depth=depth)
            restore["serial_ms" if depth == 0 else "pipelined_ms"] = st["ms"]
            restore["files"], restore["bytes"] = st["files"], st["bytes"]
        stats = region.recovery_stats
        out["reopen"] = {
            "open_ms": open_ms,
            "manifest_load_ms": stats["manifest_load_ms"],
            "wal_replay_ms": stats["wal_replay_ms"],
            "replayed_entries": stats["replayed_entries"],
            "region_open_total_ms": stats["total_ms"],
            "sst_restore": restore}
        same_scan("after reopen", want, table.scan(FIELDS).rows)

        # ---- Q1/Q2 on the recovered table: phase 2's answers bit for bit
        qe = QueryEngine(device=dev)
        k2 = rf.blocked_fold_sum.launches
        t = time.perf_counter()
        r1 = qe.execute(q1, table)
        torch.cuda.synchronize()
        q1_build_s = time.perf_counter() - t
        t = time.perf_counter()
        r2 = qe.execute(q2, table)
        torch.cuda.synchronize()
        q2_cold_s = time.perf_counter() - t
        if rf.blocked_fold_sum.launches == k2:
            raise AssertionError("Q2 on the recovered table did not run K2")
        compare_engines("durable Q1", slice_out["q1"], r1, 1)
        compare_engines("durable Q2", slice_out["q2"], r2, 1)
        # ---- the grid's restart snapshot: persist the grown entry, then
        # a fresh engine loads it and answers without a rebuild
        entry = next(iter(qe.range_cache._entries.values()))
        if entry.persist_thread is not None:
            entry.persist_thread.join()
        t = time.perf_counter()
        if not DR.persist_entry(entry, table):
            raise AssertionError("the grid snapshot was not written")
        persist_s = time.perf_counter() - t
        eng.close()
        eng, cat = durable_catalog(root, dev)
        table = cat.table("public", "cpu")
        qe = QueryEngine(device=dev)
        t = time.perf_counter()
        s1 = qe.execute(q1, table)
        torch.cuda.synchronize()
        q1_snap_s = time.perf_counter() - t
        restored = qe.last_grid
        entry = next(iter(qe.range_cache._entries.values()))
        nbytes = entry.nbytes
        t = time.perf_counter()
        s2 = qe.execute(q2, table)
        torch.cuda.synchronize()
        q2_snap_s = time.perf_counter() - t
        if restored != "restored" or qe.last_grid != "hit" \
                or entry.nbytes != nbytes:
            raise AssertionError(f"the snapshot did not answer alone: "
                                 f"{restored}, {qe.last_grid}")
        compare_engines("snapshot Q1", slice_out["q1"], s1, 1)
        compare_engines("snapshot Q2", slice_out["q2"], s2, 1)
        out["snapshot"] = {
            "persist_s": persist_s, "grid_bytes": nbytes,
            "q1_cold_rebuild_s": q1_build_s, "q2_after_rebuild_s": q2_cold_s,
            "q1_cold_from_snapshot_s": q1_snap_s,
            "q2_after_snapshot_s": q2_snap_s}
        eng.close()

        # ---- a crash before flush: the child's acknowledged rows come
        # back, and the second reopen replays nothing
        child = subprocess.run(
            [sys.executable, "-c", CRASH_CHILD, here, root, str(dev),
             str(args.seed), str(args.hosts), str(args.hours)],
            capture_output=True, text=True, timeout=300, cwd=here)
        if child.returncode != 0 or "ACK" not in child.stdout:
            raise AssertionError(f"crash child failed: {child.stderr}")
        t = time.perf_counter()
        eng, cat = durable_catalog(root, dev)
        crash_open_ms = (time.perf_counter() - t) * 1e3
        table = cat.table("public", "cpu")
        replayed = table.region.recovery_stats["replayed_entries"]
        tags, ts, fields = crash_batch(args.seed, args.hosts, args.hours)
        got = table.scan(FIELDS, ts_min=int(ts.min())).rows
        order = np.lexsort((ts, np.repeat(np.arange(args.hosts),
                                          len(ts) // args.hosts)))
        if (replayed < 1 or got is None or len(got) != len(ts)
                or not np.array_equal(got.ts, ts[order])
                or any(not np.array_equal(got.fields[f], fields[f][order])
                       for f in FIELDS)):
            raise AssertionError("acknowledged rows lost in the crash")
        eng.close()
        eng, cat = durable_catalog(root, dev)
        second = cat.table("public", "cpu").region.recovery_stats[
            "replayed_entries"]
        eng.close()
        if second != 0:
            raise AssertionError(f"second reopen replayed {second} entries")
        out["crash"] = {"acked_rows": len(ts), "replayed_entries": replayed,
                        "reopen_ms": crash_open_ms,
                        "recovery_flush_ms": table.region.recovery_stats.get(
                            "recovery_flush_ms"),
                        "second_reopen_replayed": second}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"gather_planes": mg.gather_planes.launches,
                "blocked_fold_sum": rf.blocked_fold_sum.launches}
    emit({"phase": "durable", **out, "launches": launches,
          "checks": {"scan_identical_after_compaction": True,
                     "scan_identical_after_reopen": True,
                     "q1_q2_identical": True, "snapshot_identical": True,
                     "crash_rows_read_back": True,
                     "second_reopen_replays_nothing": True},
          "phase_seconds": time.perf_counter() - t_phase})
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} never launched in phase durable")
    return launches


def check_high_cpu(table, name, res):
    """A high-cpu result against a numpy mask over the table's scan."""
    rows = table.scan(["usage_user", "usage_system"]).rows
    sel = rows.fields["usage_user"] > 90.0
    if name == "high_cpu_1":
        host = np.asarray(table.region.series.tag_values("hostname"))
        sel &= host[rows.sid] == "host_17"
    if res.num_rows != int(sel.sum()) or not np.array_equal(
            np.asarray(res.column("ts").values), rows.ts[sel]) or not (
            np.array_equal(np.asarray(res.column("usage_system").values),
                           rows.fields["usage_system"][sel])):
        raise AssertionError(f"{name} differs from a numpy filter")
    return int(sel.sum())


# ---- phase 12: server ----------------------------------------------------

LP_BATCH = 10_000           # lines a body: tsbs_load's default --batch-size
RW_SERIES, RW_METRICS, RW_SAMPLES = 1_000, 20, 40
RW_STEP_MS = 15_000
RW_SEND = 2_000             # samples a WriteRequest: max_samples_per_send
RW_JOBS = 10


def lp_bodies(tags, ts, fields):
    """One run as line-protocol bodies of LP_BATCH lines (precision ms)."""
    fmt = ("cpu,hostname={},region={} "
           + ",".join(f"{f}={{}}" for f in FIELDS) + " {}")
    cols = [list(map(repr, fields[f].tolist())) for f in FIELDS]
    lines = list(map(fmt.format, tags["hostname"].tolist(),
                     tags["region"].tolist(), *cols, ts.tolist()))
    return ["\n".join(lines[i:i + LP_BATCH])
            for i in range(0, len(lines), LP_BATCH)]


def run_bodies(run):
    """lp_bodies of one put run (a pool worker's task)."""
    return lp_bodies(*run[1:])


def server_batches(args, rng, hosts, region_of, pool):
    """Phase 12's writes in order: ("lp", body) line-protocol bodies of
    each hour's four runs and its re-delivery (phase 2's rows: the same
    rng, drawn as phase 2 draws it), each followed by ("sql", flush), then
    ("sql", DELETE) for the hour's tombstones (1 % of its rows: 1 % of the
    hosts, drawn from their own rng, over the hour) and a flush. The
    bodies are formatted on `pool`'s worker processes, ahead of the
    writes."""
    flush = "ADMIN flush_table('cpu')"
    hours = list(tsbs_hours(rng, hosts, region_of, args.server_hours))
    bodies = pool.imap(run_bodies, [run for runs in hours
                                    for run in runs[:5]])
    gone_rng = np.random.default_rng(args.seed + 12)
    for h in range(len(hours)):
        for _ in range(5):
            for body in next(bodies):
                yield "lp", body
            yield "sql", flush
        gone = gone_rng.choice(len(hosts), max(1, len(hosts) // 100),
                               replace=False)
        names = ", ".join(f"'{hosts[i]}'" for i in sorted(gone))
        yield "sql", (f"DELETE FROM cpu WHERE hostname IN ({names}) AND "
                      f"ts >= {h * HOUR_MS} AND ts < {(h + 1) * HOUR_MS}")
        yield "sql", flush


def rw_requests():
    """Remote write: RW_METRICS metrics x RW_SERIES series (job, instance
    labels), RW_SAMPLES samples at RW_STEP_MS, as snappy WriteRequests of
    RW_SEND samples (whole series)."""
    from greptimedb_tpu_torch.servers import snappy
    from greptimedb_tpu_torch.servers.prom_store import (
        _field_bytes,
        _field_double,
        _field_varint,
    )

    rng = np.random.default_rng(17)
    per = RW_SEND // RW_SAMPLES
    stamps = [_field_varint(2, k * RW_STEP_MS) for k in range(RW_SAMPLES)]
    for m in range(RW_METRICS):
        counters = np.cumsum(rng.random((RW_SERIES, RW_SAMPLES)) * 10,
                             axis=1)
        for s0 in range(0, RW_SERIES, per):
            msg = []
            for s in range(s0, s0 + per):
                labels = b"".join(
                    _field_bytes(1, _field_bytes(1, k.encode())
                                 + _field_bytes(2, v.encode()))
                    for k, v in (("__name__", f"m_{m}"),
                                 ("job", f"j{s % RW_JOBS}"),
                                 ("instance", f"i{s}")))
                samples = b"".join(
                    _field_bytes(2, _field_double(1, float(v)) + st)
                    for v, st in zip(counters[s].tolist(), stamps))
                msg.append(_field_bytes(1, labels + samples))
            yield snappy.compress(b"".join(msg))


def http_call(port, path, data=None, headers=None):
    """(status, body bytes, headers) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def http_sql(port, text):
    import urllib.parse

    status, body, _ = http_call(
        port, "/v1/sql", urllib.parse.urlencode({"sql": text}).encode(),
        {"Content-Type": "application/x-www-form-urlencoded"})
    if status != 200:
        raise AssertionError(f"/v1/sql {status}: {body[:300]!r}: {text[:80]}")
    doc = json.loads(body)
    doc.pop("execution_time_ms")
    return doc


def json_result(doc):
    """The last output of a /v1/sql answer as columns (names, num_rows,
    cols with values and valid_mask), for compare_engines."""
    from types import SimpleNamespace

    rec = doc["output"][-1]["records"]
    names = [c["name"] for c in rec["schema"]["column_schemas"]]
    cols = []
    for j in range(len(names)):
        vals = [r[j] for r in rec["rows"]]
        mask = np.array([v is not None for v in vals], bool)
        kinds = {type(v) for v in vals if v is not None}
        if kinds <= {int}:
            arr = np.array([0 if v is None else v for v in vals], np.int64)
        elif kinds <= {int, float}:
            arr = np.array([0.0 if v is None else v for v in vals],
                           np.float64)
        else:
            arr = np.array(["" if v is None else v for v in vals], object)
        cols.append(SimpleNamespace(values=arr, valid_mask=mask))
    return SimpleNamespace(names=names, num_rows=rec["total_rows"],
                           cols=cols)


def cpu_sql(inst, text):
    """`text` run in process on `inst`, in the /v1/sql envelope's form."""
    from greptimedb_tpu_torch.servers.http import result_to_json

    return json.loads(json.dumps({"output": [
        result_to_json(o.result) if o.result is not None
        else {"affectedrows": o.affected_rows or 0}
        for o in inst.execute_sql(text)]}))


def prom_range(port, q, start_s, end_s, step):
    import urllib.parse

    enc = urllib.parse.urlencode({"query": q, "start": start_s,
                                  "end": end_s, "step": step})
    status, body, _ = http_call(
        port, f"/v1/prometheus/api/v1/query_range?{enc}")
    if status != 200:
        raise AssertionError(f"query_range {status}: {body[:300]!r}")
    return json.loads(body)


def prom_matrix(doc):
    """{labels: (ts list, float values)} of a matrix answer."""
    return {tuple(sorted(r["metric"].items())):
            ([v[0] for v in r["values"]],
             np.array([float(v[1]) for v in r["values"]]))
            for r in doc["data"]["result"]}


# the phase's CPU reference: a Standalone(device="cpu") in a process of
# its own (a one-worker pool, so its calls run in the order they were
# sent), fed while the card's server works
_REF = None


def ref_open(root):
    """The reference worker's initializer."""
    global _REF
    from greptimedb_tpu_torch.instance import Standalone

    _REF = Standalone(root, device="cpu")


def ref_sql(text):
    return cpu_sql(_REF, text)


def ref_write_lines(body):
    from greptimedb_tpu_torch.servers import influx

    influx.write_lines(_REF, body, precision="ms")


def ref_scan():
    return _REF.catalog.table("public", "cpu").scan(FIELDS).rows


def ref_prom(q, start_ms, end_ms, step_ms):
    """A query_range's matrix as the HTTP API writes it."""
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.servers.http import _prom_matrix_json

    return json.loads(json.dumps(_prom_matrix_json(
        *PromEngine(_REF).query_range(q, start_ms, end_ms, step_ms))))


def ref_remote_write(body):
    from greptimedb_tpu_torch.servers import prom_store

    prom_store.remote_write(_REF, body)


def ref_rw_bound(q, rate_q, end_ms, step_ms):
    """`q` (a sum by (job) of `rate_q`) as a matrix, with the step times
    and, per job and step, the sum of |rate| over the job's series: the
    matrix-product bound's scale."""
    from greptimedb_tpu_torch.promql.engine import PromEngine

    rates, ev = PromEngine(_REF).query_range(rate_q, 0, end_ms, step_ms)
    abs_sum = {}
    for lab, vals, pres in zip(rates.labels, rates.values, rates.present):
        key = (("job", lab["job"]),)
        abs_sum[key] = abs_sum.get(key, 0) + np.where(pres, np.abs(vals), 0)
    return ref_prom(q, 0, end_ms, step_ms), abs_sum, ev.step_ts


def ref_remote_read(body):
    from greptimedb_tpu_torch.servers import prom_store

    return prom_store.remote_read(_REF, body)


def ref_close():
    _REF.close()


def server_phase(args, dev):
    """Phase 12 (see the module docstring). Returns every kernel's
    launches over the phase's main path."""
    import multiprocessing as mp
    import shutil
    import tempfile

    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.promql import fast as TF
    from greptimedb_tpu_torch.servers import http as H
    from greptimedb_tpu_torch.servers import influx, snappy
    from greptimedb_tpu_torch.servers.prom_store import (
        _field_bytes,
        _field_varint,
    )
    from greptimedb_tpu_torch.storage.device_merge import (
        DEFAULT_KERNEL_MIN_ROWS,
    )

    t_phase = time.perf_counter()
    roots = [tempfile.mkdtemp(prefix="chip_smoke_server_"),
             tempfile.mkdtemp(prefix="chip_smoke_server_cpu_")]
    out, launches = {}, {}
    zero_counts(rf, mg)
    for k in GROUPED_KERNELS:
        getattr(gr, k).launches = 0

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS}}

    # PromQL requests the fast path served (the HTTP API builds a
    # PromEngine a request, so its last_fast notes are out of reach)
    fast_hits = [0]
    try_fast = TF.try_fast

    def counted_try_fast(engine, e, ev):
        hit = try_fast(engine, e, ev)
        fast_hits[0] += hit is not None
        return hit

    card = srv = pool = ref = None
    try:
        TF.try_fast = counted_try_fast
        ctx = mp.get_context("spawn")
        ref = ctx.Pool(1, initializer=ref_open, initargs=(roots[1],))
        card = Standalone(roots[0], device=dev)
        srv = H.HttpServer(card, port=0).start()
        port = srv.port

        def ref_get(res):
            return res.get(timeout=900)

        create = ("CREATE TABLE cpu (ts TIMESTAMP TIME INDEX, hostname "
                  "STRING, region STRING, "
                  + ", ".join(f"{f} DOUBLE" for f in FIELDS)
                  + ", PRIMARY KEY (hostname, region))")
        want = ref.apply_async(ref_sql, (create,))
        if http_sql(port, create) != ref_get(want):
            raise AssertionError("server CREATE TABLE differs from the CPU")

        # ---- ingest: line protocol over HTTP; the reference takes each
        # body and statement in process while the card's server works
        rng = np.random.default_rng(args.seed)
        hosts = np.array([f"host_{i}" for i in range(args.hosts)])
        region_of = np.array(AWS_REGIONS)[rng.integers(
            0, len(AWS_REGIONS), args.hosts)]
        lp_s = lp_bytes = rows = bodies = 0
        sql_s = {"delete": 0.0, "flush": 0.0}
        parse_sample = []
        pending = []
        pool = ctx.Pool(4)
        for kind, payload in server_batches(args, rng, hosts, region_of,
                                            pool):
            if kind == "lp":
                pending.append(ref.apply_async(ref_write_lines, (payload,)))
                data = payload.encode()
                t = time.perf_counter()
                status, body, _ = http_call(
                    port, "/v1/influxdb/write?precision=ms", data)
                lp_s += time.perf_counter() - t
                if status != 204:
                    raise AssertionError(f"influx write {status}: {body!r}")
                lp_bytes += len(data)
                rows += payload.count("\n") + 1
                bodies += 1
                if len(parse_sample) < 10:
                    parse_sample.append(payload)
                continue
            want = ref.apply_async(ref_sql, (payload,))
            t = time.perf_counter()
            got = http_sql(port, payload)
            sql_s["flush" if payload.startswith("ADMIN") else
                  "delete"] += time.perf_counter() - t
            for res in pending:
                ref_get(res)
            pending = []
            if got != ref_get(want):
                raise AssertionError(f"server {payload[:40]} differs from "
                                     f"the CPU")
        pool.close()
        pool.join()
        pool = None
        torch.cuda.synchronize()
        sample = "\n".join(parse_sample)
        n_sample = sample.count("\n") + 1
        parse = {}
        for name, native in (("native", True), ("python", False)):
            t = time.perf_counter()
            influx.parse_payload(sample, native=native)
            parse[name] = n_sample / (time.perf_counter() - t)
        out["ingest"] = {
            "rows": rows, "bodies": bodies, "bytes": lp_bytes,
            "http_s": lp_s, "rows_per_s_http": rows / lp_s,
            "parse_rows_per_s": parse, "parse_sample_rows": n_sample,
            "delete_s": sql_s["delete"], "flush_s": sql_s["flush"]}

        # ---- flush and compaction over /v1/sql (K1 in every window
        # merge of DEFAULT_KERNEL_MIN_ROWS rows or more)
        ref_flush = ref.apply_async(ref_sql, ("ADMIN flush_table('cpu')",))
        ref_compact = ref.apply_async(ref_sql,
                                      ("ADMIN compact_table('cpu')",))
        ref_rows = ref.apply_async(ref_scan)
        region = card.catalog.table("public", "cpu").region
        k1 = mg.gather_planes.launches
        t = time.perf_counter()
        doc = http_sql(port, "ADMIN flush_table('cpu')")
        flush_s = time.perf_counter() - t
        if doc != ref_get(ref_flush):
            raise AssertionError("server flush answer differs from the CPU")
        t = time.perf_counter()
        doc = http_sql(port, "ADMIN compact_table('cpu')")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t
        k1 = mg.gather_planes.launches - k1
        if doc != ref_get(ref_compact):
            raise AssertionError("server compaction answer differs from "
                                 "the CPU")
        big = [p for p, n in zip(region.merge_paths, region.merge_rows_in)
               if n >= DEFAULT_KERNEL_MIN_ROWS]
        if doc["output"][0]["records"]["rows"] != [[1]] or not big \
                or set(big) != {"fused"} or k1 < len(big):
            raise AssertionError(
                f"server compaction {region.merge_paths} "
                f"{region.merge_rows_in}: K1 launched {k1} times")
        out["compaction"] = {"flush_s": flush_s, "compact_s": compact_s,
                             "merges": len(region.merge_paths),
                             "rows_in": region.merge_rows_in,
                             "k1_launches": k1}
        same_scan("server scan after compaction", ref_get(ref_rows),
                  card.catalog.table("public", "cpu").scan(FIELDS).rows)

        # ---- queries over HTTP, cold then five times warm, against the
        # reference; every request's launches are counted. `kernel`: the
        # kernel each request must launch; `path`: the SQL engine's path
        suite = {n: s for n, s, *_ in sql_suite(
            args.hosts, args.server_hours, len(AWS_REGIONS))}
        span = (0, args.server_hours * 3600)
        promq = 'max by (region) (rate(cpu{__field__="usage_user"}[1m]))'
        queries = [
            ("q1", suite["double_groupby_all"], {"w": HOUR_MS // STEP_MS,
                                                 "bounded": "avg("}),
            ("q2", suite["q2_by_region"], {"kernel": "blocked_fold_sum",
                                           "path": "device"}),
            ("groupby_hostname", "SELECT hostname, avg(usage_user) FROM cpu "
             "GROUP BY hostname", {"kernel": "grouped_block_reduce",
                                   "path": "device"}),
            # the fast path's max: a segment extreme, and K2 for the
            # count of present series a group
            ("promql_max_by_region", promq, {"kernel": "blocked_fold_sum",
                                             "promql": True}),
        ]
        wants = {name: ref.apply_async(ref_prom, (text, span[0] * 1000,
                                                  span[1] * 1000, 60_000))
                 if spec.get("promql") else ref.apply_async(ref_sql, (text,))
                 for name, text, spec in queries}

        def request(text, spec):
            if spec.get("promql"):
                return prom_range(port, text, *spec.get("span", span),
                                  spec.get("step", 60))
            return http_sql(port, text)

        def counted_request(name, text, spec):
            """One request: (answer, wall s, launches, fast-path hits)."""
            before, hits = all_counts(), fast_hits[0]
            t = time.perf_counter()
            got = request(text, spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            after = all_counts()
            ran = {k: after[k] - before[k] for k in after
                   if after[k] > before[k]}
            hit = fast_hits[0] - hits
            if spec.get("kernel") and not ran.get(spec["kernel"]):
                raise AssertionError(f"server {name} did not launch "
                                     f"{spec['kernel']}: {ran}")
            if spec.get("promql") and hit != 1:
                raise AssertionError(f"server {name}: the PromQL fast path "
                                     f"served {hit} times, not once")
            if spec.get("path") and \
                    card.query_engine.last_exec_path != spec["path"]:
                raise AssertionError(
                    f"server {name} ran {card.query_engine.last_exec_path}")
            return got, wall, ran

        q_out = {}
        answers = {}
        for name, text, spec in queries:
            got, cold, cold_ran = counted_request(name, text, spec)
            warm, warm_ran = [], {}
            for _ in range(5):
                _, wall, ran = counted_request(name, text, spec)
                warm.append(wall)
                for k, v in ran.items():
                    warm_ran[k] = warm_ran.get(k, 0) + v
            want = ref_get(wants[name])
            q_out[name] = {"cold_s": cold,
                           "warm_median_s": float(np.median(warm)),
                           "launches_cold": cold_ran,
                           "launches_per_warm": {k: v / 5 for k, v
                                                 in warm_ran.items()}}
            if spec.get("promql"):
                if got != want:
                    raise AssertionError(f"server {name} differs from the "
                                         f"CPU")
                q_out[name]["series"] = len(got["data"]["result"])
                continue
            ref_res, res = json_result(want), json_result(got)
            bounded = [c for c in ref_res.names
                       if spec.get("bounded") and c.startswith(
                           spec["bounded"])]
            _, worst = compare_engines(f"server {name}", ref_res, res,
                                       spec.get("w", 1), bounded)
            answers[name] = (text, ref_res, spec)
            q_out[name].update(rows=res.num_rows, max_rel_diff_vs_cpu=worst)
        for name, text, spec in queries:
            if name in ("q2", "promql_max_by_region"):
                p = profiled(lambda: request(text, spec))
                q_out[name].update(device_ms=p["device_ms"],
                                   idle_share=p["idle_share"],
                                   profile_wall_ms=p["wall_ms"])
        out["queries"] = q_out

        # ---- Prometheus remote write into the metric engine
        t = time.perf_counter()
        n_req = 0
        rw_http_s = 0.0
        for body in rw_requests():
            pending.append(ref.apply_async(ref_remote_write, (body,)))
            t0 = time.perf_counter()
            status, resp, _ = http_call(
                port, "/v1/prometheus/write", body,
                {"Content-Encoding": "snappy",
                 "Content-Type": "application/x-protobuf"})
            rw_http_s += time.perf_counter() - t0
            if status != 204:
                raise AssertionError(f"remote write {status}: {resp!r}")
            n_req += 1
        for res in pending:
            ref_get(res)
        pending = []
        samples = RW_METRICS * RW_SERIES * RW_SAMPLES
        rwq = "sum by (job) (rate(m_0[1m]))"
        rw_span = (0, RW_SAMPLES * RW_STEP_MS // 1000)
        rw_ref = ref.apply_async(ref_rw_bound, (
            rwq, "rate(m_0[1m])", rw_span[1] * 1000, RW_STEP_MS))
        rw_spec = {"promql": True, "span": rw_span,
                   "step": RW_STEP_MS // 1000}
        doc, rw_cold, rw_ran = counted_request("remote-write query", rwq,
                                               rw_spec)
        got = prom_matrix(doc)
        want_doc, abs_sum, step_ts = ref_get(rw_ref)
        want = prom_matrix(want_doc)
        # both sides sum each job's rates in one float32 matrix product
        # (cuBLAS's order on the card, the CPU BLAS's here): |diff| <=
        # 2 gamma_n sum |x|, n = rows per fold block + 8 blocks
        s_pad = 1 << max(3, (RW_SERIES - 1).bit_length())
        n_rows = s_pad // 8 + 8
        gamma = n_rows * U / (1 - n_rows * U)
        if got.keys() != want.keys():
            raise AssertionError("remote-write query groups differ")
        rw_worst = 0.0
        for key, (ts_w, v_w) in want.items():
            ts_g, v_g = got[key]
            idx = np.searchsorted(step_ts / 1000.0, ts_w)
            if ts_g != ts_w or not np.all(
                    np.abs(v_g - v_w) <= 2 * gamma * abs_sum[key][idx]):
                raise AssertionError(f"remote-write query {key} past the "
                                     f"matrix-product bound")
            rw_worst = max(rw_worst, float(np.max(np.abs(v_g - v_w)
                                                  / np.abs(v_w))))
        rr = snappy.compress(_field_bytes(1, _field_varint(1, 0)
                                          + _field_varint(2, 10**9)
                                          + _field_bytes(3, _field_varint(1, 0)
                                          + _field_bytes(2, b"__name__")
                                          + _field_bytes(3, b"m_0"))))
        rr_want = ref.apply_async(ref_remote_read, (rr,))
        t0 = time.perf_counter()
        status, resp, _ = http_call(port, "/v1/prometheus/read", rr)
        read_s = time.perf_counter() - t0
        if status != 200 or snappy.decompress(resp) != snappy.decompress(
                ref_get(rr_want)):
            raise AssertionError("remote read differs from the CPU")
        out["remote_write"] = {
            "requests": n_req, "samples": samples, "http_s": rw_http_s,
            "samples_per_s_http": samples / rw_http_s,
            "phase_s": time.perf_counter() - t,
            "query_cold_s": rw_cold, "query_launches": rw_ran,
            "query_max_rel_diff_vs_cpu": rw_worst,
            "read_s": read_s, "read_bytes": len(resp)}

        # ---- close, reopen from the data root, Q1 again
        srv.stop()
        srv = None
        card.close()
        t = time.perf_counter()
        card = Standalone(roots[0], device=dev)
        reopen_ms = (time.perf_counter() - t) * 1e3
        card.warm_thread.join()
        srv = H.HttpServer(card, port=0).start()
        port = srv.port
        text, ref_res, spec = answers["q1"]
        got, q1_reopen_s, ran = counted_request("q1 after reopen", text,
                                                spec)
        compare_engines("server q1 after reopen", ref_res, json_result(got),
                        spec["w"], [c for c in ref_res.names
                                    if c.startswith("avg(")])
        out["reopen"] = {"open_ms": reopen_ms, "q1_cold_s": q1_reopen_s,
                         "q1_launches": ran}
        launches = all_counts()
        out["launches"] = launches
        ref_get(ref.apply_async(ref_close))
    finally:
        TF.try_fast = try_fast
        for p in (pool, ref):
            if p is not None:
                p.terminate()
                p.join()
        if srv is not None:
            srv.stop()
        if card is not None:
            card.close()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "server", "card": nvidia_smi_line(), **out})
    return launches


# ----------------------------------------------------------------------
# 13. flow
# ----------------------------------------------------------------------

FLOW_BATCH = 10_000          # rows a delta: tsbs_load's default --batch-size
FLOW_HTTP_DELTAS = 20        # the line-protocol leg's bodies
FLOW_DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, "
            + ", ".join(f"{f} DOUBLE" for f in FIELDS)
            + ", ts TIMESTAMP TIME INDEX, PRIMARY KEY (hostname, region))")
# TSBS double-groupby-all and cpu-max-all kept as a 1 h rollup, and the
# variance slots, the int32 winner stages and count/min beside them
FLOWS = {
    "cpu_1h": "CREATE FLOW cpu_1h SINK TO cpu_1h_out AS SELECT hostname, "
              "date_bin('1 hour', ts) AS hour, "
              + ", ".join(f"avg({f}) AS avg_{f}, max({f}) AS max_{f}"
                          for f in FIELDS)
              + " FROM cpu GROUP BY hostname, hour",
    "cpu_1h_stats": "CREATE FLOW cpu_1h_stats SINK TO cpu_1h_stats_out AS "
                    "SELECT hostname, date_bin('1 hour', ts) AS hour, "
                    "count(usage_user) AS n, min(usage_user) AS lo, "
                    "stddev_samp(usage_user) AS sd, "
                    "first_value(usage_user ORDER BY ts) AS fv, "
                    "last_value(usage_user ORDER BY ts) AS lv "
                    "FROM cpu GROUP BY hostname, hour",
}
# the state slot of cpu_1h_stats' variance shift k (count 1, min 2 slots)
FLOW_SHIFT_SLOT = 3


def flow_deltas(args):
    """Phase 13's writes in order: phase 2's TSBS rows (the same rng, drawn
    as phase 2 draws them), each hour's four 15-minute runs (no
    re-delivery, no tombstones) cut into deltas of FLOW_BATCH rows, as
    (hour, run, data, valid) in `_insert`'s columnar form."""
    rng = np.random.default_rng(args.seed)
    hosts = np.array([f"host_{i}" for i in range(args.hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.hosts)]
    for h, runs in enumerate(tsbs_hours(rng, hosts, region_of, args.hours)):
        for r, (_, tags, ts, fields) in enumerate(runs[:4]):
            for a in range(0, len(ts), FLOW_BATCH):
                b = min(a + FLOW_BATCH, len(ts))
                data = {"ts": ts[a:b],
                        **{k: v[a:b].astype(object) for k, v in tags.items()},
                        **{f: fields[f][a:b] for f in FIELDS}}
                yield h, r, data, {k: np.ones(b - a, bool) for k in data}


def flow_standalone(root, dev, x64=False, flows=FLOWS):
    """A Standalone on `dev` in `root` with the cpu table and `flows`,
    ticked by hand."""
    from greptimedb_tpu_torch.instance import Standalone

    inst = Standalone(root, device=dev, x64=x64, warm_start=False)
    inst.enable_flows(tick_interval_s=3600)
    inst.sql(FLOW_DDL)
    for name in flows:
        inst.sql(FLOWS[name])
    return inst


def flow_write(inst, data, valid):
    """`_insert`'s columnar write, then the flows' delta; returns the
    host seconds of the delta (`on_insert`)."""
    table = inst.catalog.table("public", "cpu")
    inst._write_columns(table, data, valid)
    t = time.perf_counter()
    inst._notify_flows("public", "cpu", table, data, valid)
    return time.perf_counter() - t


def flow_sinks(inst, names=FLOWS):
    """{sink: (column names, [(values, valid mask)])} of the flows `names`,
    ordered by the keys: numpy arrays, which pickle."""
    out = {}
    for n in names:
        res = inst.sql(f"SELECT * FROM {n}_out ORDER BY hostname, hour")
        out[f"{n}_out"] = (list(res.names),
                           [(np.asarray(c.values), np.asarray(c.valid_mask))
                            for c in res.cols])
    return out


def flow_states(inst, names=FLOWS):
    """{flow: (capacity, key rows, [slot arrays])} of the device states."""
    out = {}
    for n in names:
        ds = inst.flows.maybe_flow(n).device_state
        if ds is None:
            raise AssertionError(f"flow {n} left the device path")
        out[n] = (ds.capacity, list(ds.key_rows()),
                  [s.cpu().numpy() for s in ds.state])
    return out


def same_sinks(what, a, b):
    """Sinks cell for cell, floats bit for bit, validity too (the tick's
    wall clock in update_at aside)."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: sinks {sorted(a)} vs {sorted(b)}")
    for sink in a:
        (na, ca), (nb, cb) = a[sink], b[sink]
        if na != nb or len(ca[0][0]) != len(cb[0][0]):
            raise AssertionError(f"{what} {sink}: {len(ca[0][0])} rows "
                                 f"{na} vs {len(cb[0][0])} {nb}")
        for name, (va, ma), (vb, mb) in zip(na, ca, cb):
            if va.dtype.kind == "f":
                va, vb = va.view(np.uint64), vb.view(np.uint64)
            if name != "update_at" and (not np.array_equal(va, vb)
                                        or not np.array_equal(ma, mb)):
                raise AssertionError(f"{what}: {sink}.{name} differs")


def same_flow_states(what, a, b):
    """flow_states of two runs slot for slot, bit for bit."""
    for n in a:
        (ca, ka, sa), (cb, kb, sb) = a[n], b[n]
        if ca != cb or ka != kb:
            raise AssertionError(f"{what}: flow {n} groups differ")
        for i, (x, y) in enumerate(zip(sa, sb)):
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f"{what}: flow {n} slot {i} differs")


def flow_cpu_run(seed, hosts, x64, names):
    """The reference of checks 1 and 4, in a worker process: the port on
    the CPU (G's plain versions) fed phase 13's first hour, drawn from the
    same seed, and ticked once. Returns its sinks, its states and its
    failure counts."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    torch.set_num_threads(2)
    root = tempfile.mkdtemp(prefix="chip_smoke_flow_cpu_")
    try:
        inst = flow_standalone(root, "cpu", x64=x64, flows=names)
        n = 0
        for _, _, data, valid in flow_deltas(SimpleNamespace(
                seed=seed, hosts=hosts, hours=1)):
            flow_write(inst, data, valid)
            n += 1
        inst.flows.flush_all()
        out = {"deltas": n, "sinks": flow_sinks(inst, names),
               "states": flow_states(inst, names),
               "failed": (inst.flows.failed_applies,
                          inst.flows.failed_ticks)}
        inst.close()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_cpu_run(what, ref, sinks, states):
    """A worker's flow_cpu_run result against the card's."""
    if ref["failed"] != (0, 0):
        raise AssertionError(f"{what}: the cpu run failed {ref['failed']}")
    same_sinks(what, sinks, ref["sinks"])
    same_flow_states(what, states, ref["states"])


def flow_ok(what, inst):
    """No delta or tick failed, no flow left the device."""
    fm = inst.flows
    if fm.failed_applies or fm.failed_ticks:
        raise AssertionError(f"{what}: {fm.failed_applies} failed applies, "
                             f"{fm.failed_ticks} failed ticks")
    for n in fm.flow_names():
        if fm.maybe_flow(n).device_state is None:
            raise AssertionError(f"{what}: flow {n} was demoted")


@contextlib.contextmanager
def count_g_forms(gr, store):
    """Count G's calls by (form, dtype) and keep the last call of each (the
    state's final capacity) while this block is open; the wrapper runs as
    it would and its launch count is carried on the recorder (as
    capture_grouped does)."""
    real = gr.grouped_block_reduce

    def g(v, members, form):
        key = (form, str(v.dtype).removeprefix("torch."))
        store.setdefault("calls", {}).setdefault(key, 0)
        store["calls"][key] += 1
        store[key] = (v, members)
        return real(v, members, form)

    g.launches = real.launches
    gr.grouped_block_reduce = g
    try:
        yield
    finally:
        real.launches = g.launches
        gr.grouped_block_reduce = real


@contextlib.contextmanager
def tick_timers(DS, FM, store):
    """Host seconds of the tick's finalize + readback
    (DeviceFlowState.finalize_snapshot) and of its sink upsert
    (FlowManager._emit_groups), summed into `store` while open."""
    fin = DS.DeviceFlowState.finalize_snapshot
    emit_ = FM.FlowManager._emit_groups

    def timed(fn, key):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if key == "finalize_readback_s":
                    torch.cuda.synchronize()
                store[key] = store.get(key, 0.0) + time.perf_counter() - t
        return wrapper

    DS.DeviceFlowState.finalize_snapshot = timed(fin, "finalize_readback_s")
    FM.FlowManager._emit_groups = timed(emit_, "sink_upsert_s")
    try:
        yield
    finally:
        DS.DeviceFlowState.finalize_snapshot = fin
        FM.FlowManager._emit_groups = emit_


def flow_phase(args, dev):
    """Phase 13 (see the module docstring). Returns every kernel's
    launches over the phase's main path, G's entries at the flow's shape
    and its float64 max/min form."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.flow import device_state as DS
    from greptimedb_tpu_torch.flow import manager as FM
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.servers import http as H

    import multiprocessing as mp

    t_phase = time.perf_counter()
    roots = [tempfile.mkdtemp(prefix=f"chip_smoke_flow{i}_")
             for i in range(4)]
    out, insts, srv, pool = {}, [], None, None
    zero_counts(rf, mg)
    for k in GROUPED_KERNELS:
        getattr(gr, k).launches = 0

    def all_counts():
        return {**counts(rf, mg),
                **{k: getattr(gr, k).launches for k in GROUPED_KERNELS}}

    def opened(*a, **k):
        inst = flow_standalone(*a, **k)
        insts.append(inst)
        return inst

    try:
        # the CPU references of checks 1 and 4 run in two worker processes
        # while the card writes
        pool = mp.get_context("spawn").Pool(2)
        refs = {"f32": pool.apply_async(flow_cpu_run, (
                    args.seed, args.hosts, False, tuple(FLOWS))),
                "x64": pool.apply_async(flow_cpu_run, (
                    args.seed, args.hosts, True, ("cpu_1h_stats",)))}

        # ---- the write with both flows on the card, a tick at the
        # end of every hour
        card = opened(roots[0], dev)
        first_hour, first = [], {}
        hosts_rows = {}      # per hour and run: the usage_* columns
        host_s, g_per_delta, ticks = [], [], []
        store, timers = {}, {}
        rows = 0

        def tick():
            t = time.perf_counter()
            card.flows.flush_all()
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t)

        t_write = time.perf_counter()
        with count_g_forms(gr, store), tick_timers(DS, FM, timers):
            for h, r, data, valid in flow_deltas(args):
                if h == 1 and not first:
                    tick()
                    first["sinks"] = flow_sinks(card)
                    first["states"] = flow_states(card)
                elif h and r == 0 and len(ticks) < h:
                    tick()
                if h == 0:
                    first_hour.append((data, valid))
                runs = hosts_rows.setdefault(h, [{} for _ in range(4)])
                for f in FIELDS:
                    runs[r].setdefault(f, []).append(data[f])
                before = gr.grouped_block_reduce.launches
                host_s.append(flow_write(card, data, valid))
                g_per_delta.append(gr.grouped_block_reduce.launches - before)
                rows += len(data["ts"])
            tick()
            if not first:
                first["sinks"] = flow_sinks(card)
                first["states"] = flow_states(card)
        write_s = time.perf_counter() - t_write
        n_deltas = len(host_s)
        per_run = HOUR_MS // STEP_MS // 4 * args.hosts
        if n_deltas != args.hours * 4 * -(-per_run // FLOW_BATCH):
            raise AssertionError(f"flow: {n_deltas} deltas")
        if min(g_per_delta) == 0 or len(set(g_per_delta)) != 1:
            raise AssertionError(f"flow: G launches a delta "
                                 f"{sorted(set(g_per_delta))}")
        flow_ok("flow card", card)
        groups = {n: card.flows.maybe_flow(n).device_state.num_groups
                  for n in FLOWS}
        if set(groups.values()) != {args.hosts * args.hours}:
            raise AssertionError(f"flow: groups {groups}")
        out["write"] = {
            "deltas": n_deltas, "rows": rows, "seconds": write_s,
            "rows_per_s": rows / write_s,
            "on_insert_host_ms_median": float(np.median(host_s)) * 1e3,
            "on_insert_host_ms_mean": float(np.mean(host_s)) * 1e3,
            "on_insert_host_ms_p99": float(np.percentile(host_s, 99)) * 1e3,
            "on_insert_host_s_total": float(np.sum(host_s)),
            "g_launches_per_delta": g_per_delta[0],
            "g_calls_by_form": {f"{k[0]} {k[1]}": v for k, v in
                                store["calls"].items()},
            "groups": groups,
            "hourly_tick_ms": [x * 1e3 for x in ticks],
            "hourly_tick_parts_ms": {k.replace("_s", "_ms"): v * 1e3
                                     for k, v in timers.items()},
            "state_bytes": {n: card.flows.maybe_flow(n).device_state.nbytes()
                            for n in FLOWS}}
        timers.clear()

        # ---- check 1: the first hour's sinks and states against the CPU
        # port (a worker's run)
        t = time.perf_counter()
        ref = refs["f32"].get(timeout=900)
        if ref["deltas"] != len(first_hour):
            raise AssertionError(f"flow cpu run: {ref['deltas']} deltas")
        check_cpu_run("flow first hour card vs cpu", ref, first["sinks"],
                      first["states"])
        out["first_hour_vs_cpu_wait_s"] = time.perf_counter() - t

        # ---- check 2: every hour against numpy
        t = time.perf_counter()
        out["vs_numpy"] = flow_check_numpy(args, card, hosts_rows)
        out["vs_numpy"]["seconds"] = time.perf_counter() - t

        # ---- the tick over every group: finalize, readback, sink upsert
        for n in FLOWS:
            ds = card.flows.maybe_flow(n).device_state
            ds.dirty[:ds.num_groups] = True
        with tick_timers(DS, FM, timers):
            t = time.perf_counter()
            card.flows.flush_all()
            torch.cuda.synchronize()
            full_tick = time.perf_counter() - t
        out["tick_all_groups"] = {
            "groups": sum(groups.values()), "ms": full_tick * 1e3,
            **{k.replace("_s", "_ms"): v * 1e3 for k, v in timers.items()}}

        # ---- check 3: line protocol over HTTP against the columnar route
        t = time.perf_counter()
        lp = opened(roots[2], dev)
        col = opened(roots[3], dev)
        srv = H.HttpServer(lp, port=0).start()
        bodies = []
        for data, valid in first_hour[:FLOW_HTTP_DELTAS]:
            tags = {k: data[k] for k in ("hostname", "region")}
            bodies += lp_bodies(tags, data["ts"], data)
        if len(bodies) != FLOW_HTTP_DELTAS:
            raise AssertionError(f"flow: {len(bodies)} line-protocol bodies")
        t_http = time.perf_counter()
        for body in bodies:
            status, resp, _ = http_call(srv.port, "/v1/influxdb/write?"
                                        "precision=ms", body.encode())
            if status != 204:
                raise AssertionError(f"influx write {status}: {resp[:200]!r}")
        http_s = time.perf_counter() - t_http
        for data, valid in first_hour[:FLOW_HTTP_DELTAS]:
            flow_write(col, data, valid)
        lp.flows.flush_all()
        col.flows.flush_all()
        same_sinks("flow line protocol vs columnar", flow_sinks(lp),
                   flow_sinks(col))
        same_flow_states("flow line protocol vs columnar", flow_states(lp),
                         flow_states(col))
        for inst in (lp, col):
            flow_ok("flow http leg", inst)
        out["line_protocol"] = {
            "bodies": len(bodies), "rows": FLOW_HTTP_DELTAS * FLOW_BATCH,
            "http_s": http_s,
            "rows_per_s_http": FLOW_HTTP_DELTAS * FLOW_BATCH / http_s,
            "seconds": time.perf_counter() - t}
        srv.stop()
        srv = None

        # ---- check 4: x64, cpu_1h_stats over the first hour
        t = time.perf_counter()
        store64 = {}
        stats = ("cpu_1h_stats",)
        x64 = opened(roots[1], dev, x64=True, flows=stats)
        with count_g_forms(gr, store64):
            for data, valid in first_hour:
                flow_write(x64, data, valid)
            x64.flows.flush_all()
        torch.cuda.synchronize()
        calls64 = store64.get("calls", {})
        for key in (("sum", "float64"), ("min", "float64")):
            if not calls64.get(key):
                raise AssertionError(f"flow x64: G {key} never ran")
        flow_ok("flow x64", x64)
        states64 = flow_states(x64, stats)
        # slot 1: min's value (slot 0 is the int32 count)
        if states64["cpu_1h_stats"][2][1].dtype != np.float64:
            raise AssertionError("flow x64: state is not float64")
        launches = all_counts()
        check_cpu_run("flow x64 card vs cpu", refs["x64"].get(timeout=900),
                      flow_sinks(x64, stats), states64)
        out["x64"] = {"deltas": len(first_hour),
                      "g_calls_by_form": {f"{k[0]} {k[1]}": v
                                          for k, v in calls64.items()},
                      "seconds": time.perf_counter() - t}

        # ---- profile one warm delta on the card (after the checks: it
        # folds the last delta in once more)
        data, valid = first_hour[-1]
        table = card.catalog.table("public", "cpu")
        before = gr.grouped_block_reduce.launches
        prof = profiled(lambda: card._notify_flows("public", "cpu", table,
                                                   data, valid), top=6)
        out["profile_one_delta"] = {
            **prof, "g_launches": gr.grouped_block_reduce.launches - before,
            "g_device_ms": device_ms_per_launch(
                prof, lambda k: k.startswith(("segment_walk_kernel",
                                              "group_fold_kernel")))}

        # ---- G at the flow's shapes, and its float64 max/min form
        t = time.perf_counter()
        kern = flow_kernel_rows(dev, gr, store, store64, prof)
        out["kernels_s"] = time.perf_counter() - t
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        if srv is not None:
            srv.stop()
        for inst in insts:
            inst.close()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "flow", "card": nvidia_smi_line(), **out})
    return launches, kern


def flow_check_numpy(args, card, hosts_rows):
    """Check 2: after the last hour every (host, hour) of both sinks against
    numpy over the written rows, cast to float32 as the default mode's
    slots hold them. count, min, max, first_value and last_value equal
    exactly. avg within (M - 1) u mean|x| + 4 u |mean|: each delta's
    batch sum adds at most M = 90 rows of a group (the ninety 10 s steps of
    a 15-minute run) in order from 0, the batch sums fold with Neumaier's
    compensation (2 u |sum|), then one add and one division round.
    stddev_samp within dvar / (2 sd) + u sd, dvar = u ((M + 8) A + 2 (M +
    1) |S| sum|x - k| / n) / (n - 1) over the shifted sums A = sum (x -
    k)^2, S = sum (x - k) with the state's shift k: each shifted value and
    square rounds once, the sums as above, and the finalize's mean,
    quotient, fma, ratio and product once each."""
    per_run = HOUR_MS // STEP_MS // 4
    m = per_run
    hosts = np.array([f"host_{i}" for i in range(args.hosts)], object)
    sinks = flow_sinks(card)
    one = sinks["cpu_1h_out"]
    st = sinks["cpu_1h_stats_out"]
    n_rows = args.hosts * args.hours
    for names, cols in (one, st):
        if len(cols[0][0]) != n_rows:
            raise AssertionError(f"flow sink rows {len(cols[0][0])}")
    # sink rows ordered (hostname, hour): hostname sorts as strings
    order = np.argsort(hosts)
    ds = card.flows.maybe_flow("cpu_1h_stats").device_state
    gid = {k: i for i, k in enumerate(ds.key_rows())}
    shift = ds.state[FLOW_SHIFT_SLOT].cpu().numpy()
    worst = {"avg_abs": 0.0, "avg_over_bound": 0.0, "sd_abs": 0.0,
             "sd_over_bound": 0.0}

    def col(res, name):
        names, cols = res
        return cols[names.index(name)][0].reshape(args.hosts, args.hours)

    for h in range(args.hours):
        runs = hosts_rows[h]
        v = {f: np.concatenate([np.concatenate(r[f]).reshape(
            args.hosts, per_run) for r in runs], axis=1).astype(
            np.float32)[order] for f in FIELDS}
        for f in FIELDS:
            x = v[f].astype(np.float64)
            if not np.array_equal(col(one, f"max_{f}")[:, h],
                                  x.max(axis=1)):
                raise AssertionError(f"flow max({f}) hour {h} differs")
            mean = x.mean(axis=1)
            err = np.abs(col(one, f"avg_{f}")[:, h] - mean)
            bound = U * ((m - 1) * np.abs(x).mean(axis=1)
                         + 4 * np.abs(mean))
            if (err > bound).any():
                raise AssertionError(f"flow avg({f}) hour {h} past its "
                                     f"bound: {err.max()}")
            worst["avg_abs"] = max(worst["avg_abs"], float(err.max()))
            worst["avg_over_bound"] = max(worst["avg_over_bound"],
                                          float((err / bound).max()))
        x = v["usage_user"].astype(np.float64)
        n = x.shape[1]
        for name, want in (("n", np.full(args.hosts, n, np.float64)),
                           ("lo", x.min(axis=1)), ("fv", x[:, 0]),
                           ("lv", x[:, -1])):
            if not np.array_equal(col(st, name)[:, h], want):
                raise AssertionError(f"flow {name} hour {h} differs")
        k = shift[[gid[(hosts[i], h * HOUR_MS)] for i in order]].astype(
            np.float64)[:, None]
        a = ((x - k) ** 2).sum(axis=1)
        s = (x - k).sum(axis=1)
        sd_ref = x.std(axis=1, ddof=1)
        dvar = U * ((m + 8) * a + 2 * (m + 1) * np.abs(s)
                    * np.abs(x - k).sum(axis=1) / n) / (n - 1)
        bound = dvar / (2 * sd_ref) + U * sd_ref
        err = np.abs(col(st, "sd")[:, h] - sd_ref)
        if (err > bound).any():
            raise AssertionError(f"flow stddev_samp hour {h} past its "
                                 f"bound: {err.max()}")
        worst["sd_abs"] = max(worst["sd_abs"], float(err.max()))
        worst["sd_over_bound"] = max(worst["sd_over_bound"],
                                     float((err / bound).max()))
    return {"groups": n_rows, "exact": ["count", "min", "max",
                                        "first_value", "last_value"],
            **worst}


def flow_kernel_rows(dev, gr, store, store64, prof):
    """G at the flow's shapes (the main run's last float32 sum and max,
    one row block over the state's capacity) and G's float64 max/min form
    (the x64 leg's last min, and edge inputs: NaN payloads of both signs, +-0.0,
    +-inf, masked and empty groups, ragged segments, one and eight row
    blocks) against their plain versions, bit for bit, timed beside their
    bounds and scatter_reduce."""
    errs = []

    def exact(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"{what} differs from its plain version")
        errs.append(float(torch.nan_to_num(
            (got.double() - want.double()).abs(), nan=0.0).max()))

    def ext_bytes(members, width):
        live = int(members.ptr[-1])
        return ((width + 4) * live + 4 * (members.gb * members.blocks + 1)
                + width * members.gb)

    def timed(v, members, form, width, ops_per_s):
        live = members.perm[:int(members.ptr[-1])].long()
        seg = torch.repeat_interleave(
            torch.arange(members.gb * members.blocks, device=dev),
            (members.ptr[1:] - members.ptr[:-1]).long()) // members.blocks
        nbytes = ext_bytes(members, width)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = int(members.ptr[-1]) / ops_per_s * 1e3
        if form == "sum":
            def library():
                return torch.zeros(members.gb, dtype=v.dtype,
                                   device=dev).index_add_(0, seg, v[live])
        else:
            def library():
                return torch.full((members.gb,), -torch.inf if form == "max"
                                  else torch.inf, dtype=v.dtype,
                                  device=dev).scatter_reduce_(
                    0, seg, v[live], "amax" if form == "max" else "amin")
        ms = cuda_ms(lambda: gr.grouped_block_reduce(v, members, form))
        return {"ms": ms,
                "burst_ms": burst_ms(lambda: gr.grouped_block_reduce(
                    v, members, form)),
                "plain_ms": cuda_ms(lambda: gr.grouped_block_reduce_plain(
                    v, members, form), reps=3, warm=1),
                "library_ms": cuda_ms(library),
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "bytes": nbytes,
                "shape": {"rows": v.numel(), "live_rows": int(members.ptr[-1]),
                          "blocks": members.blocks, "gb": members.gb,
                          **segment_stats(members)}}

    out = {}
    # the main run's first sum (avg(usage_user)) and max, float32
    for form in ("sum", "max"):
        v, members = store[(form, "float32")]
        exact(f"G flow {form}", gr.grouped_block_reduce(v, members, form),
              gr.grouped_block_reduce_plain(v, members, form))
        out[form] = timed(v, members, form, 4, F32_OPS_PER_S)
        out[form]["share_of_bound"] = (out[form]["bound_ms"]
                                       / out[form]["burst_ms"])
    out["device_ms_per_launch_in_delta"] = device_ms_per_launch(
        prof, lambda k: k.startswith("segment_walk_kernel<float, 0>"))
    # the float64 max/min form: the x64 leg's min, then edge inputs
    v64, m64 = store64[("min", "float64")]
    for form in ("min", "max"):
        exact(f"G f64 {form} flow", gr.grouped_block_reduce(v64, m64, form),
              gr.grouped_block_reduce_plain(v64, m64, form))
    rng = np.random.default_rng(29)
    for layout in ("random", "runs"):
        for n, blocks, gb in ((10_000, 1, 4096), (30_011, 8, 64),
                              (20_000, 1, 16), (50_000, 256, 1)):
            v, members = edge_members(dev, gr, rng, n, blocks, gb, layout)
            bits = v.view(torch.int32).cpu().numpy()
            # the float32 edge bits widened (payloads and signs kept)
            v = torch.from_numpy(bits.view(np.float32).astype(
                np.float64)).to(dev)
            for form in ("max", "min"):
                exact(f"G f64 {form} edge {layout} {n}x{blocks}x{gb}",
                      gr.grouped_block_reduce(v, members, form),
                      gr.grouped_block_reduce_plain(v, members, form))
    f64 = timed(v64, m64, "min", 8, F64_OPS_PER_S)
    f64["max_abs_err"] = max(errs)
    f64["launches_x64_leg"] = store64["calls"][("min", "float64")]
    return {"flow": out, "float64_ext_form": f64, "max_abs_err": max(errs)}


# ----------------------------------------------------------------------
# phase 14: SQL window functions
# ----------------------------------------------------------------------

WINDOW_HOSTS = 61       # bench.py:2242's 61 hosts: 263,520 rows at 12 h
WINDOW_WARM = 7         # bench.py:2253's runs of the window metric
S_SOURCE = "greptimedb_tpu_torch/parallel/kernels/csrc/segmented_scan.cu"
# (form, value dtype) of every S form the window path runs
S_FORMS = (("add", torch.int32), ("add", torch.int64),
           ("add", torch.float64), ("max", torch.float64),
           ("min", torch.float64), ("comp", torch.float32),
           ("max2", torch.float32), ("min2", torch.float32))


def window_sql(hosts: int) -> dict:
    """The phase's queries over the first `hosts` hosts: bench.py's
    metric (sum), its max and count, and the sliding frame."""
    where = ("FROM cpu WHERE hostname IN ("
             + ", ".join(f"'host_{i}'" for i in range(hosts)) + ")")
    run = "OVER (PARTITION BY hostname ORDER BY ts)"
    rows = ("OVER (PARTITION BY hostname ORDER BY ts ROWS BETWEEN 5 "
            "PRECEDING AND CURRENT ROW)")
    return {
        "sum": f"SELECT hostname, ts, sum(usage_user) {run} {where}",
        "max_count": (f"SELECT hostname, ts, max(usage_user) {run}, "
                      f"count(usage_user) {run} {where}"),
        "rows_pre": (f"SELECT hostname, ts, sum(usage_user) {rows}, "
                     f"count(usage_user) {rows} {where}"),
    }


def window_table(args, dev):
    """bench.py's table for the window metric: phase 2's TSBS devops rows
    (same seed, 4000 hosts, 12 h at 10 s, ten usage_* fields), each hour's
    four 15-minute runs without the re-delivery and tombstone runs, so
    that every host keeps its 4,320 rows and 61 hosts are the metric's
    263,520; compacted on the card. Returns (table, seconds, the hosts'
    regions, K1's launches in the compaction)."""
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg

    t = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    hosts = np.array([f"host_{i}" for i in range(args.hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.hosts)]
    table = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
                  fields=FIELDS)
    for runs in tsbs_hours(rng, hosts, region_of, args.hours):
        for run in runs[:4]:
            write_run(table, run)
    k1 = mg.gather_planes.launches
    table.compact(device=dev, verify=False, kernels="on")
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return (table, time.perf_counter() - t, region_of,
            mg.gather_planes.launches - k1)


def same_window_result(what, a, b):
    """Two window answers equal bit for bit (values and validity)."""
    if a.names != b.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: shapes differ")
    for x, y in zip(a.cols, b.cols):
        vx, vy = np.asarray(x.values), np.asarray(y.values)
        if not np.array_equal(x.valid_mask, y.valid_mask) or \
                vx.dtype != vy.dtype or not np.array_equal(
                    vx.view(np.uint8) if vx.dtype.kind == "f" else vx,
                    vy.view(np.uint8) if vy.dtype.kind == "f" else vy):
            raise AssertionError(f"{what}: the card differs from the CPU")


def scan_inputs(dev, n, per, dtype, seed, edge=False):
    """One S form's inputs on the card (float32: the two-float forms' hi
    and lo): n rows, a reset every `per` rows
    (per = 1: every row; per = n: row 0 only). Values are TSBS-like
    usage in [0, 100); `edge` adds NaN of both signs (float64), +-0.0 and
    +-inf (float64), and for the two-float forms -0.0 and hi parts that
    tie."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.zeros(n, dtype=torch.bool, device=dev)
    r[::per] = True
    if dtype in (torch.int32, torch.int64):
        hi = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=dtype)
        if edge:
            big = torch.iinfo(dtype).max // 4
            hi = torch.randint(-big, big, (n,), generator=g, device=dev,
                               dtype=dtype)
        return [hi], r
    v = torch.rand(n, generator=g, device=dev, dtype=torch.float64) * 100
    pick = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    if edge and dtype == torch.float64:
        v[pick < 0.02] = torch.inf
        v[(pick >= 0.02) & (pick < 0.04)] = -torch.inf
        v[(pick >= 0.04) & (pick < 0.06)] = -0.0
        v[(pick >= 0.06) & (pick < 0.07)] = 0.0
        v[(pick >= 0.07) & (pick < 0.08)] = torch.nan
        v[(pick >= 0.08) & (pick < 0.09)] = -torch.nan
    elif edge:
        v = torch.round(v) * 1e6 + torch.randint(
            0, 4, (n,), generator=g, device=dev) * 1e-3
        v[pick < 0.05] = -0.0
    if dtype == torch.float64:
        return [v], r
    hi = v.float()
    lo = (v - hi.double()).float()
    return [hi, lo], r


def host_breakdown(fn) -> dict:
    """Cumulative host ms of one call of fn in the functions of the SQL
    window path, under cProfile (which slows the call down; the shares
    are what it reads)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wanted = {"execute": "executor.py", "_scan": "executor.py",
              "eval_window": "window_fns.py", "_key_codes": "window_fns.py",
              "_sort_indices": "executor.py", "_dispatch": "window_fns.py",
              "_running_scans": "window_fns.py", "unique": "arraysetops",
              "segmented_scan": "segmented_scan.py", "read_full": "readback"}
    out = {}
    for (path, _, func), row in pstats.Stats(prof).stats.items():
        if func in wanted and wanted[func] in path:
            out[func] = out.get(func, 0.0) + row[3] * 1e3
    return out


S_KERNEL = "segscan_kernel<"     # every instantiation of S's one kernel


def s_profile(fn, calls=3, per_call=1, sessions=3) -> dict | None:
    """S's kernel under torch.profiler: one call of fn as the schedule's
    warm-up step, then `calls` calls recorded; None when no session (of
    up to `sessions`) saw device activity at all. In a long process the
    profiler loses some kernel records (a session of one launch often
    shows none), so its count is a floor: `events` S launches were seen
    in `calls` calls, `device_ms` is the device time of one seen launch.
    Raises when the profiler saw device activity and none of it was S's,
    or more S launches than `per_call` a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(sessions):
        seen = []    # the recorded step's events (the cycle clears them)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: seen.extend(
                         p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        dev = [e for e in seen
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total]
        if dev:
            break
    else:
        return None
    ours = [e for e in dev if S_KERNEL in e.key]
    if not ours:
        raise AssertionError("the profiler saw device activity and no "
                             "launch of S's kernel: "
                             + ", ".join(e.key[:60] for e in dev[:4]))
    events = sum(e.count for e in ours)
    if events > calls * per_call:
        raise AssertionError(f"S: {events} kernel launches in {calls} "
                             f"calls")
    total = sum(e.self_device_time_total for e in ours) / 1e3
    return {"device_ms": total / events, "total_ms": total,
            "events": events, "calls": calls}


def s_bytes(form, dtype, n) -> int:
    """S's bytes: each input read once (values and the reset flag), each
    output written once."""
    width = torch.tensor([], dtype=dtype).element_size()
    vals = 2 if form in ("comp", "max2", "min2") else 1
    return n * (vals * width + 1) + n * vals * width


def s_check(dev, ss, form, dtype, xs, r, errs):
    """S against its plain version on the same inputs, bit for bit (the
    add forms hold NaN positions: the card's add returns its canonical
    NaN, ROADMAP C2)."""
    got = ss.segmented_scan(form, xs[0], r, *xs[1:])
    want = ss.segmented_scan_plain(form, xs[0], r, *xs[1:])
    torch.cuda.synchronize()
    keep = torch.ones_like(want, dtype=torch.bool)
    if got.dtype.is_floating_point:
        nan = torch.isnan(want)
        if not torch.equal(nan, torch.isnan(got)):
            raise AssertionError(f"S {form} {dtype}: NaN positions differ")
        if form == "add":
            keep = ~nan
    g, w = got[keep], want[keep]
    if not torch.equal(g.view(torch.uint8) if g.is_floating_point() else g,
                       w.view(torch.uint8) if w.is_floating_point() else w):
        raise AssertionError(f"S {form} {dtype} differs from its plain "
                             f"version")
    errs.append(float((g.double() - w.double()).abs().nan_to_num(nan=0.0)
                      .max()) if g.numel() else 0.0)


def s_edge_sizes(ss, form, dtype, dev) -> dict:
    """Row counts at S's edges: its tile's (2^k - 1, 2^k, 2^k + 1), the
    resident form's (tiles = the blocks the card holds at once, and one
    more: the streaming form), and past one block's capacity of totals
    (2^k (2^k + 1) + 5 rows: the totals take a second level)."""
    tile = ss.tile_rows()
    grid = ss.resident_tiles(form, dtype, dev)
    return {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "resident": grid * tile, "resident+1": (grid + 1) * tile,
            "totals_past_one_block": tile * (tile + 1) + 5}


def s_kernel_rows(dev, ss, n_full, per, launches, metric_launches):
    """S alone: every form at the full table's rows (one reset per host)
    and at the metric's 263,520 rows against its plain version, bit for
    bit, with edge inputs and reset patterns at the kernel's edges, and
    timed beside its bytes bound, its plain version and torch.cumsum over
    the same rows (no resets; for scale only: no PyTorch call computes a
    segmented scan). Each timed shape is one launch of the wrapper and at
    most one of S's kernel by the profiler's count."""
    errs = []
    n_metric = WINDOW_HOSTS * per
    # edge inputs and reset patterns, across the kernel's tile levels
    edges = {}
    for form, dtype in S_FORMS:
        sizes = s_edge_sizes(ss, form, dtype, dev)
        edges[f"{form}_{str(dtype).split('.')[-1]}"] = sizes
        for n in (1, 2, 100_003, n_metric, *sizes.values()):
            for every in (1, 7, 4320, n):
                if n > 10_000_000 and every == 7:
                    continue
                xs, r = scan_inputs(dev, n, every, dtype,
                                    seed=n + every, edge=True)
                s_check(dev, ss, form, dtype, xs, r, errs)
    forms = {}
    for form, dtype in S_FORMS:
        key = f"{form}_{str(dtype).split('.')[-1]}"
        forms[key] = {}
        for shape, n in (("full_table", n_full), ("metric", n_metric)):
            xs, r = scan_inputs(dev, n, per, dtype, seed=n)
            s_check(dev, ss, form, dtype, xs, r, errs)
            nbytes = s_bytes(form, dtype, n)

            def kernel(xs=xs, r=r, form=form):
                return ss.segmented_scan(form, xs[0], r, *xs[1:])

            before = ss.segmented_scan.launches
            kernel()
            if ss.segmented_scan.launches != before + 1:
                raise AssertionError(f"S {key} {shape}: one call counted "
                                     f"{ss.segmented_scan.launches - before}"
                                     f" launches")
            prof = s_profile(kernel)
            forms[key][shape] = {
                "rows": n, "resets": int(r.sum()),
                "ms": cuda_ms(kernel),
                "device_ms": prof and prof["device_ms"],
                "profiler_s_events": prof and f"{prof['events']} in "
                                             f"{prof['calls']} scans",
                "host_ms": host_ms(kernel),
                "plain_ms": cuda_ms(lambda xs=xs, r=r, form=form:
                                    ss.segmented_scan_plain(
                                        form, xs[0], r, *xs[1:]),
                                    reps=3, warm=1),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                "cumsum_ms_for_scale": cuda_ms(
                    lambda xs=xs: torch.cumsum(xs[0], 0)),
            }
            forms[key][shape]["share_of_bound"] = (
                forms[key][shape]["bound_ms"] / forms[key][shape]["ms"])
    head = forms["add_float64"]["full_table"]
    return {
        "name": "segmented_scan", "route": "cuda", "source": S_SOURCE,
        "replaces": "greptimedb_tpu/ops/segment.py:211-292 "
                    "(jax.lax.associative_scan; XLA, not a Pallas kernel)",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "cumsum_ms_for_scale": head["cumsum_ms_for_scale"],
        "headline": "add float64 at the full table",
        "profiler_s_events": head["profiler_s_events"],
        "launches_per_warm_metric_query": metric_launches,
        "edge_sizes": edges,
        "forms": forms,
    }


def window_phase(args, dev):
    """Phase 14 (see the module docstring). Returns kernel S's row and
    what phase 15 takes: the table, its hosts' regions and K1's launches
    in its compaction."""
    from greptimedb_tpu_torch.instance import Instance
    from greptimedb_tpu_torch.parallel import mesh as M
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss

    t_phase = time.perf_counter()
    table, t_table, region_of, k1_launches = window_table(args, dev)
    per = args.hours * (HOUR_MS // STEP_MS)
    queries = window_sql(WINDOW_HOSTS)

    def instance(device, x64):
        inst = Instance(device=device, x64=x64)
        inst.catalog.register(table)
        return inst

    ss.segmented_scan.launches = 0
    out = {"rows": WINDOW_HOSTS * per}
    cpu_answers = {}
    for x64 in (False, True):
        card, cpu = instance(dev, x64), instance("cpu", x64)
        mode = "x64" if x64 else "f32"
        for name in ("sum", "max_count"):
            sql = queries[name]
            t = time.perf_counter()
            res = card.sql(sql)
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t) * 1e3
            if card.query_engine.last_window_path != "device":
                raise AssertionError(f"window {name} {mode} ran "
                                     f"{card.query_engine.last_window_path}")
            if res.num_rows != out["rows"]:
                raise AssertionError(f"window {name}: {res.num_rows} rows")
            times = []
            metric = name == "sum" and not x64
            for _ in range(WINDOW_WARM if metric else 3):
                t = time.perf_counter()
                card.sql(sql)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            want = cpu_answers[mode, name] = cpu.sql(sql)
            cpu_ms = (time.perf_counter() - t) * 1e3
            if cpu.query_engine.last_window_path != "device":
                raise AssertionError(f"CPU window {name} {mode} ran "
                                     f"{cpu.query_engine.last_window_path}")
            same_window_result(f"window {name} {mode}", res, want)
            out[f"{name}_{mode}"] = {
                "cold_ms": cold, "warm_ms_median": float(np.median(times)),
                "warm_ms": times, "cpu_port_ms": cpu_ms,
                "profile_warm": profiled(lambda: card.sql(sql)),
            }
    out["sql_window_running_sum_262k_ms"] = out["sum_f32"]["warm_ms_median"]
    # the metric's scan and projection alone, without the window: the
    # share of the warm wall that is not window work
    scan_sql = queries["sum"].replace(
        "sum(usage_user) OVER (PARTITION BY hostname ORDER BY ts)",
        "usage_user")
    out["scan_only_warm_ms"] = host_ms(lambda: card.sql(scan_sql), reps=3,
                                       warm=1)
    out["metric_host_breakdown_ms"] = host_breakdown(
        lambda: instance(dev, False).sql(queries["sum"]))
    # the sliding frame over 4 shards on the card (x64: the JAX package
    # shards it only with x64), the same mesh on the CPU run
    M.reset_for_tests()
    M.configure(M.MeshOptions(enabled=True, axis_size=4), device=dev)
    try:
        card, cpu = instance(dev, True), instance("cpu", True)
        sql = queries["rows_pre"]
        t = time.perf_counter()
        res = card.sql(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        want = cpu.sql(sql)
        paths = (card.query_engine.last_window_path,
                 cpu.query_engine.last_window_path)
        if paths != ("device_mesh", "device_mesh"):
            raise AssertionError(f"sliding window ran {paths}")
        same_window_result("window rows_pre x64 mesh", res, want)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            card.sql(sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out["rows_pre_x64_mesh4"] = {"cold_ms": cold,
                                     "warm_ms_median": float(np.median(times))}
    finally:
        M.reset_for_tests()
    launches = ss.segmented_scan.launches
    out["s_launches_main_path"] = launches
    out["table_seconds"] = t_table
    # S in one warm metric query: the wrapper's launches, and the device
    # time and kernel launches the profiler reads
    warm = instance(dev, False)
    warm.sql(queries["sum"])
    before = ss.segmented_scan.launches
    warm.sql(queries["sum"])
    torch.cuda.synchronize()
    metric_launches = ss.segmented_scan.launches - before
    in_query = s_profile(lambda: warm.sql(queries["sum"]), calls=1,
                         per_call=metric_launches)
    t = time.perf_counter()
    row = s_kernel_rows(dev, ss, args.hosts * per, per, launches,
                        metric_launches)
    out["kernel_seconds"] = time.perf_counter() - t
    row["device_ms_in_warm_metric_query"] = in_query and in_query[
        "total_ms"]
    row["profiler_s_events_in_warm_metric_query"] = in_query and (
        f"{in_query['events']} of {metric_launches}")
    out["k1_launches_compaction"] = k1_launches
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "window", **out})
    if launches == 0:
        raise AssertionError("kernel segmented_scan never launched on the "
                             "window path")
    return [row], {"table": table, "region_of": region_of,
                   "k1_launches": k1_launches}


REL_WARM = 3            # warm runs of each phase-15 query (median)
REL_HOUR = "ts < 3600000"   # the first hour: 1.44 M rows at 4000 hosts
# TSBS devops host tags (cmd/tsbs_generate_data/devops/host.go in the
# TSBS sources): each region's datacenters, 100 racks a datacenter, three
# operating systems
TSBS_DATACENTERS = {
    "us-east-1": "abce", "us-west-1": "ab", "us-west-2": "abc",
    "eu-west-1": "abc", "eu-central-1": "ab", "ap-southeast-1": "ab",
    "ap-southeast-2": "ab", "ap-northeast-1": "ac", "sa-east-1": "abc",
}
TSBS_RACKS = 100
TSBS_OS = ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")
REL_DDL = ("CREATE TABLE tags (ts TIMESTAMP TIME INDEX, hostname STRING "
           "PRIMARY KEY, region STRING, datacenter STRING, rack STRING, "
           "os STRING)")
REL_VIEW = ("CREATE VIEW hot AS SELECT hostname, avg(usage_user) AS u "
            f"FROM cpu WHERE {REL_HOUR} GROUP BY hostname")
REL_QUERIES = {
    # a join, then GROUP BY over the 1.44 M-row frame through G
    "R1": ("SELECT t.datacenter, count(*), avg(c.usage_user), "
           "max(c.usage_system) FROM cpu c JOIN tags t ON c.hostname = "
           f"t.hostname WHERE c.{REL_HOUR} GROUP BY t.datacenter "
           "ORDER BY t.datacenter"),
    # an uncorrelated IN over a device GROUP BY
    "R2": (f"SELECT hostname, max(usage_user) FROM cpu WHERE {REL_HOUR} "
           f"AND hostname IN (SELECT hostname FROM cpu WHERE {REL_HOUR} "
           "GROUP BY hostname HAVING avg(usage_user) > 50) "
           "GROUP BY hostname ORDER BY hostname"),
    # a RANGE on the grid inside a CTE, joined
    "R3": ("WITH h AS (SELECT ts, hostname, avg(usage_user) RANGE '1h' "
           "AS u FROM cpu ALIGN '1h' BY (hostname)) SELECT t.region, h.ts, "
           "max(h.u) FROM h JOIN tags t ON h.hostname = t.hostname "
           "GROUP BY t.region, h.ts ORDER BY t.region, h.ts"),
    # a correlated scalar subquery that decorrelate accepts
    "R4": ("SELECT c.hostname, c.ts, c.usage_user FROM cpu c WHERE "
           f"c.{REL_HOUR} AND c.usage_user > (SELECT avg(d.usage_user) + 49 "
           "FROM cpu d WHERE d.hostname = c.hostname AND "
           f"d.{REL_HOUR}) ORDER BY c.hostname, c.ts"),
    # set operations: the first hour's hot hosts (a GROUP BY on cpu)
    # against the hosts of one os
    "R5_except": (f"SELECT hostname FROM cpu WHERE {REL_HOUR} GROUP BY "
                  "hostname HAVING max(usage_user) > 99 EXCEPT SELECT "
                  f"hostname FROM tags WHERE os = '{TSBS_OS[1]}'"),
    "R5_intersect_all": (f"SELECT hostname FROM cpu WHERE {REL_HOUR} "
                         "GROUP BY hostname HAVING max(usage_user) > 99 "
                         "INTERSECT ALL SELECT hostname FROM tags WHERE "
                         f"os = '{TSBS_OS[1]}'"),
    # a view, joined and grouped
    "R6": ("SELECT t.region, count(*), avg(h.u), max(h.u) FROM hot h "
           "JOIN tags t ON h.hostname = t.hostname GROUP BY t.region "
           "ORDER BY t.region"),
}


# the columns held to a bound against the CPU port, not bit for bit: R3's
# CTE averages 360 ten-second cells of the grid an hour, and torch sums
# a window's cells in another order on the card than on the CPU (ROADMAP
# C2's disjoint-window tolerance), so its max stays within 2 (w - 1) u
# relative (compare_engines); every other column, and every other query,
# bit for bit
REL_BOUNDED = {"R3": ("max(h.u)",)}


def relational_tags(seed, region_of, batch=1000) -> list:
    """The tags table's INSERT statements: one row a host (host_i, its
    cpu-table region), with a datacenter of that region, a rack and an
    os drawn from `seed` as TSBS devops draws them."""
    rng = np.random.default_rng(seed + 15)
    rows = []
    for i, region in enumerate(region_of):
        dcs = TSBS_DATACENTERS[str(region)]
        dc = f"{region}{dcs[rng.integers(len(dcs))]}"
        rack = int(rng.integers(TSBS_RACKS))
        os_ = TSBS_OS[rng.integers(len(TSBS_OS))]
        rows.append(f"(0, 'host_{i}', '{region}', '{dc}', '{rack}', "
                    f"'{os_}')")
    return ["INSERT INTO tags VALUES " + ", ".join(rows[k:k + batch])
            for k in range(0, len(rows), batch)]


def relational_standalones(args, dev, window_out, name, roots, insts,
                           devices=None):
    """A card Standalone and a CPU one (prefer_device=True; `devices`
    names others), each in a temporary data root (appended to `roots`,
    the instances to `insts`) with phase 14's table registered as `cpu`
    and the tags table and the `hot` view made by SQL. Returns the
    instances made."""
    import tempfile

    from greptimedb_tpu_torch.instance import Standalone

    devices = (dev, "cpu") if devices is None else devices
    for device in devices:
        roots.append(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
        inst = Standalone(roots[-1], device=device, prefer_device=True,
                          warm_start=False)
        insts.append(inst)
        inst.catalog.register(window_out["table"])
        for stmt in [REL_DDL] + relational_tags(
                args.seed, window_out["region_of"]) + [REL_VIEW]:
            inst.execute_sql(stmt)
    return tuple(insts[-len(devices):])


# phases 15 to 17's CPU reference: phase 14's table built again on the
# CPU from the same seed (the same rows, compacted by the CPU port), in a
# process of its own (a one-worker pool, so its calls run in the order
# they were sent), which builds while phases 14 and 15 run and answers
# while the card works
_WREF = None
_WREF_CTX = {}


def wref_open(seed, hosts, hours, root):
    """The reference worker's initializer: phase 14's table registered as
    cpu in a CPU Standalone in `root`, with the tags table and the view of
    phases 15 and 16; query sessions off, as on the card in phases 1 to
    16."""
    global _WREF
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.query import sessions

    torch.set_num_threads(4)
    sessions.configure({"enable": False})
    args = argparse.Namespace(seed=seed, hosts=hosts, hours=hours)
    table, _, region_of, _ = window_table(args, "cpu")
    _WREF = Standalone(root, device="cpu", prefer_device=True,
                       warm_start=False)
    _WREF.catalog.register(table)
    for stmt in [REL_DDL] + relational_tags(seed, region_of) + [REL_VIEW]:
        _WREF.execute_sql(stmt)


def wref_sql(text, ctx=None):
    """(result, seconds) of `text` on the reference; statements that name
    the same `ctx` share one session (PREPARE, then EXECUTE)."""
    from greptimedb_tpu_torch.session import QueryContext

    c = None if ctx is None else _WREF_CTX.setdefault(ctx, QueryContext())
    t = time.perf_counter()
    res = _WREF.sql(text, c)
    return res, time.perf_counter() - t


def wref_close():
    _WREF.close()


def start_window_reference(args):
    """The reference worker of phases 15 to 17 (see above), in a
    temporary data root; stop_window_reference stops it."""
    import multiprocessing as mp
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_wref_")
    pool = mp.get_context("spawn").Pool(
        1, initializer=wref_open, initargs=(args.seed, args.hosts,
                                            args.hours, root))
    _WREF_POOL.append((pool, root))
    return pool


class RefCalls:
    """Calls to the reference worker, sent ahead and collected in order:
    `ask` sends one, `got` waits for its answer and adds the worker's
    seconds and the time the phase waited to `seconds`/`waited`."""

    def __init__(self, pool):
        self.pool = pool
        self.seconds = 0.0
        self.waited = 0.0

    def ask(self, text, ctx=None):
        return self.pool.apply_async(wref_sql, (text, ctx))

    def got(self, fut):
        t = time.perf_counter()
        res, s = fut.get(timeout=900)
        self.waited += time.perf_counter() - t
        self.seconds += s
        return res


def relational_phase(args, dev, window_out, wref):
    """Phase 15 (see the module docstring); `wref` is the CPU reference
    worker (start_window_reference). Returns the launches of the kernels
    its queries ran on the card."""
    import shutil

    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query import stats

    t_phase = time.perf_counter()
    table = window_out["table"]
    roots, insts = [], []
    out = {"rows": int(table.row_count())}
    try:
        t = time.perf_counter()
        ref = RefCalls(wref)    # the CPU port's answers, from the worker
        asked = {name: ref.ask(sql) for name, sql in REL_QUERIES.items()}
        asked_tags = ref.ask("SELECT datacenter FROM tags")
        card, = relational_standalones(args, dev, window_out, "relational",
                                       roots, insts, devices=(dev,))
        out["setup_seconds"] = time.perf_counter() - t
        gr.grouped_block_reduce.launches = 0
        rf.blocked_fold_sum.launches = 0
        results = {}
        qe = card.query_engine
        ranges = []     # (exec path, program) of each RANGE plan it runs
        real_execute = qe.execute

        def execute(plan, table):
            res = real_execute(plan, table)
            if plan.kind == "range":
                ranges.append((qe.last_exec_path,
                               (qe.last_range or {}).get("program")))
            return res

        qe.execute = execute
        for name, sql in REL_QUERIES.items():
            ranges.clear()
            before = gr.grouped_block_reduce.launches
            t = time.perf_counter()
            res = card.sql(sql)
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t) * 1e3
            g_cold = gr.grouped_block_reduce.launches - before
            path, range_paths, grid = (qe.last_exec_path, list(ranges),
                                       qe.last_grid)
            times, joined = [], None
            for k in range(REL_WARM):
                # the first warm call under the stats collector: the
                # join's host ms and rows
                with (stats.collect() if k == 0
                      else contextlib.nullcontext()) as st:
                    t = time.perf_counter()
                    card.sql(sql)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
                if k == 0:
                    joined = dict(st.counters)
            if res.num_rows == 0:
                raise AssertionError(f"relational {name}: no rows")
            if g_cold == 0:
                raise AssertionError(f"relational {name}: G never launched")
            # a set operation's last leaf is the tags scan (host); every
            # other query ends in an aggregate, which must take the card
            if path != "device" and not name.startswith("R5"):
                raise AssertionError(f"relational {name}: its last "
                                     f"aggregate ran on the {path}")
            results[name] = res
            prof = profiled(lambda: card.sql(sql))
            out[name] = {
                "rows_out": res.num_rows, "cold_ms": cold,
                "warm_ms_median": float(np.median(times)), "warm_ms": times,
                "device_ms": prof["device_ms"],
                "idle_share": prof["idle_share"],
                "join_ms": joined.get("join_ms"),
                "join_rows": joined.get("join_rows"),
                "g_launches_cold": g_cold,
                "range_plans": range_paths, "grid": grid,
                "profile_warm": prof,
            }
        # the CPU port's answers, in the order they were asked
        for name, res in results.items():
            s0 = ref.seconds
            want = ref.got(asked[name])
            identical, worst = True, 0.0
            if name in REL_BOUNDED:
                if [np.asarray(c.values).dtype for c in res.cols] != [
                        np.asarray(c.values).dtype for c in want.cols]:
                    raise AssertionError(f"relational {name}: dtypes")
                identical, worst = compare_engines(
                    f"relational {name}", want, res, HOUR_MS // STEP_MS,
                    bounded=REL_BOUNDED[name])
            else:
                same_window_result(f"relational {name}", res, want)
            out[name].update({"cpu_port_ms": (ref.seconds - s0) * 1e3,
                              "bit_identical_to_cpu": identical,
                              "max_rel_diff_to_cpu": worst})
            emit({"relational_query": name,
                  **{k: v for k, v in out[name].items()
                     if k not in ("profile_warm", "warm_ms")}})
        if out["R3"]["range_plans"] != [("device", "single")] or \
                out["R3"]["grid"] != "built":
            raise AssertionError(f"relational R3: the CTE took "
                                 f"{out['R3']['range_plans']}, grid "
                                 f"{out['R3']['grid']}")
        # R1's counts against the tags: every host keeps 360 rows in the
        # first hour
        r1 = results["R1"]
        got = dict(zip(r1.column("datacenter").values.tolist(),
                       r1.column("count(*)").values.tolist()))
        want = {}
        for d in ref.got(asked_tags).cols[0].values:
            want[d] = want.get(d, 0) + HOUR_MS // STEP_MS
        if got != want:
            raise AssertionError("relational R1: counts differ from the "
                                 "tags table's")
    finally:
        for inst in insts:
            inst.close()
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    launches = {"grouped_block_reduce": gr.grouped_block_reduce.launches,
                "blocked_fold_sum": rf.blocked_fold_sum.launches}
    out["launches"] = launches
    out["cpu_reference_seconds"] = ref.seconds
    out["cpu_reference_wait_seconds"] = ref.waited
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "relational", **out})
    return launches


SESSION_WARM = 3        # warm runs of each phase-16 timing (median)
SESSION_Q2 = ("SELECT ts, region, " + ", ".join(
    f"{op}(usage_user) RANGE '2h'" for op in SQL_Q2_OPS)
    + " FROM cpu ALIGN '1h' BY (region)")
SESSION_GROUPBY = ("SELECT hostname, max(usage_user), avg(usage_system) "
                   f"FROM cpu WHERE {REL_HOUR} GROUP BY hostname "
                   "ORDER BY hostname")
SESSION_PREPARE = ("PREPARE g AS SELECT hostname, max(usage_user) FROM cpu "
                   "WHERE ts >= $1 AND ts < $2 GROUP BY hostname "
                   "ORDER BY hostname")
SESSION_LITERAL = ("SELECT hostname, max(usage_user) FROM cpu WHERE ts >= "
                   "{lo} AND ts < {hi} GROUP BY hostname ORDER BY hostname")
# the system-table queries a SQL client sends: the two tables' rows,
# columns and keys, the golden information_schema_joins join and psql's
# \dt (pg_class JOIN pg_namespace)
SESSION_SYSTEM = {
    "tables": ("SELECT table_name, table_type, engine, region_count FROM "
               "information_schema.tables WHERE table_name IN ('cpu', "
               "'tags') ORDER BY table_name"),
    "columns": ("SELECT table_name, column_name, data_type, semantic_type, "
                "is_nullable FROM information_schema.columns WHERE "
                "table_name IN ('cpu', 'tags') ORDER BY table_name, "
                "column_name"),
    "key_column_usage": ("SELECT table_name, constraint_name, column_name, "
                         "ordinal_position FROM "
                         "information_schema.key_column_usage WHERE "
                         "table_name IN ('cpu', 'tags') ORDER BY "
                         "table_name, constraint_name, ordinal_position"),
    "joins": ("SELECT t.table_name, c.column_name FROM "
              "information_schema.tables t JOIN information_schema.columns "
              "c ON c.table_name = t.table_name WHERE t.table_schema = "
              "'public' ORDER BY t.table_name, c.column_name"),
    "psql_dt": ("SELECT n.nspname, c.relname FROM pg_catalog.pg_class c "
                "JOIN pg_catalog.pg_namespace n ON n.oid = c.relnamespace "
                "WHERE n.nspname = 'public' AND c.relkind = 'r' ORDER BY "
                "c.relname"),
}


def session_queries() -> dict:
    """Phase 16's EXPLAIN and EXPLAIN ANALYZE targets: Q2 on the grid, a
    GROUP BY hostname over the first hour, R1 and the window metric's
    query."""
    return {"Q2": SESSION_Q2, "groupby": SESSION_GROUPBY,
            "R1": REL_QUERIES["R1"],
            "window": window_sql(WINDOW_HOSTS)["sum"]}


def session_victim(hours: int) -> str:
    """ADMIN kill's victim: a UNION ALL of the hourly GROUP BYs, one scan
    (one cancellation checkpoint) a leaf."""
    return " UNION ALL ".join(
        SESSION_LITERAL.format(lo=h * HOUR_MS, hi=(h + 1) * HOUR_MS)
        .replace(" ORDER BY hostname", "") for h in range(hours))


def explain_parts(res):
    """(plan lines, row count or None, {key: value}) of an EXPLAIN or
    EXPLAIN ANALYZE answer."""
    lines = [str(v) for v in res.cols[0].values]
    at = next((i for i, ln in enumerate(lines)
               if ln.startswith("  Metrics:")), len(lines))
    rows = None
    if at < len(lines):
        rows = int(lines[at].split("rows=")[1].split()[0])
    notes = dict(ln.strip().split(": ", 1) for ln in lines[at + 1:])
    return lines[:at], rows, notes


def session_phase(args, dev, window_out, wref):
    """Phase 16 (see the module docstring); `wref` is the CPU reference
    worker (start_window_reference). Returns the launches of the kernels
    its statements ran on the card."""
    import shutil
    import threading

    from greptimedb_tpu_torch.errors import (
        ExecutionError,
        InvalidArgumentError,
    )
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss
    from greptimedb_tpu_torch.servers.http import HttpServer, result_to_json
    from greptimedb_tpu_torch.session import QueryContext

    t_phase = time.perf_counter()
    roots, insts, srv = [], [], None
    out = {"rows": int(window_out["table"].row_count())}
    mods = {"grouped_block_reduce": gr, "blocked_fold_sum": rf,
            "segmented_scan": ss}

    def counts():
        return {n: getattr(m, n).launches for n, m in mods.items()}

    def walls(fn):
        ts = [walls_one(fn) for _ in range(SESSION_WARM)]
        return float(np.median(ts)), ts

    ref = RefCalls(wref)    # the CPU port's answers, from the worker

    def g_launches(fn):
        before = gr.grouped_block_reduce.launches
        res = fn()
        torch.cuda.synchronize()
        return res, gr.grouped_block_reduce.launches - before

    # every reference call, sent ahead in the order the checks read them
    # (Q2 runs once before its EXPLAIN ANALYZE: the grid's note then
    # reads "hit" on both sides)
    asked = {}
    for name, q in session_queries().items():
        asked["explain", name] = ref.ask(f"EXPLAIN {q}")
        if name == "Q2":
            asked["Q2"] = ref.ask(q)
        asked["analyze", name] = ref.ask(f"EXPLAIN ANALYZE {q}")
    ref.ask(SESSION_PREPARE, "prepared")
    for h in (0, 1):
        asked["execute", h] = ref.ask(
            f"EXECUTE g ({h * HOUR_MS}, {(h + 1) * HOUR_MS})", "prepared")
    victim_sql = session_victim(args.hours)
    asked["victim"] = ref.ask(victim_sql)
    for name, q in SESSION_SYSTEM.items():
        asked["system", name] = ref.ask(q)
    try:
        t = time.perf_counter()
        (card,) = relational_standalones(args, dev, window_out, "session",
                                         roots, insts, devices=(dev,))
        out["setup_seconds"] = time.perf_counter() - t
        for n, m in mods.items():
            getattr(m, n).launches = 0

        # ---- EXPLAIN and EXPLAIN ANALYZE -----------------------------
        explain, t_part = {}, time.perf_counter()
        launched = None
        for name, q in session_queries().items():
            cpu0 = ref.seconds
            plan = explain_parts(card.sql(f"EXPLAIN {q}"))[0]
            if plan != explain_parts(ref.got(asked["explain", name]))[0]:
                raise AssertionError(f"session EXPLAIN {name}: plan lines "
                                     f"differ from the CPU port's")
            t = time.perf_counter()
            plain = card.sql(q)
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t) * 1e3
            if name == "Q2":
                ref.got(asked["Q2"])
            # warm: the plain query and its EXPLAIN ANALYZE in turns
            # (plain first, then EXPLAIN ANALYZE first, ...: a drift of
            # the host's speed falls on both); the first EXPLAIN ANALYZE
            # is checked
            plain_ts, ea_ts, first = [], [], None

            def analyzed():
                nonlocal first, launched
                before = counts()
                t = time.perf_counter()
                got = card.sql(f"EXPLAIN ANALYZE {q}")
                torch.cuda.synchronize()
                ea_ts.append((time.perf_counter() - t) * 1e3)
                if first is None:
                    launched = {n: c - before[n]
                                for n, c in counts().items()}
                    first = got

            for k in range(SESSION_WARM):
                if k % 2:
                    analyzed()
                plain_ts.append(walls_one(lambda: card.sql(q)))
                if k % 2 == 0:
                    analyzed()
            lines, rows, notes = explain_parts(first)
            _, cpu_rows, cpu_notes = explain_parts(
                ref.got(asked["analyze", name]))
            if lines != plan or rows != plain.num_rows or rows != cpu_rows:
                raise AssertionError(f"session EXPLAIN ANALYZE {name}: "
                                     f"plan or rows ({rows}, plain "
                                     f"{plain.num_rows}, cpu {cpu_rows})")
            if set(notes) != set(cpu_notes) or any(
                    notes[k] != cpu_notes[k] for k in notes
                    if not k.endswith("_ms")):
                raise AssertionError(f"session EXPLAIN ANALYZE {name}: "
                                     f"card {notes} cpu {cpu_notes}")
            path_key, kernel = {
                "Q2": ("exec_path_range", "blocked_fold_sum"),
                "groupby": ("exec_path_aggregate", "grouped_block_reduce"),
                "R1": ("exec_path_aggregate", "grouped_block_reduce"),
                "window": ("exec_path_window", "segmented_scan"),
            }[name]
            if notes.get(path_key) != "device":
                raise AssertionError(f"session EXPLAIN ANALYZE {name}: "
                                     f"{path_key} {notes.get(path_key)}")
            if launched[kernel] == 0:
                raise AssertionError(f"session EXPLAIN ANALYZE {name}: "
                                     f"{kernel} never launched")
            if name == "Q2" and card.query_engine.last_range[
                    "program"] != "single":
                raise AssertionError("session Q2 left the grid's program")
            explain[name] = {
                "rows": rows, "cold_ms": cold, "launches": launched,
                "notes": {k: v for k, v in notes.items()
                          if not k.endswith("_ms")},
                "warm_ms_median": float(np.median(plain_ts)),
                "explain_analyze_warm_ms_median": float(np.median(ea_ts)),
                "overhead_pct": 100.0 * (np.median(ea_ts)
                                         / np.median(plain_ts) - 1.0),
                "warm_ms": plain_ts, "explain_analyze_warm_ms": ea_ts,
                "cpu_port_seconds": ref.seconds - cpu0,
            }
            emit({"session_explain": name, **explain[name]})
        out["explain"] = explain
        out["explain_seconds"] = time.perf_counter() - t_part

        # ---- PREPARE / EXECUTE / DEALLOCATE --------------------------
        t_part = time.perf_counter()
        pctx = QueryContext()
        card.execute_sql(SESSION_PREPARE, pctx)
        execute = {}
        for h in (0, 1):
            lo, hi = h * HOUR_MS, (h + 1) * HOUR_MS
            run_ = f"EXECUTE g ({lo}, {hi})"
            literal = SESSION_LITERAL.format(lo=lo, hi=hi)
            got, g_n = g_launches(lambda: card.sql(run_, pctx))
            if g_n == 0:
                raise AssertionError(f"session {run_}: G never launched")
            same_window_result(f"session {run_} vs literal", got,
                               card.sql(literal))
            same_window_result(f"session {run_} vs cpu", got,
                               ref.got(asked["execute", h]))
            ex_ts, lit_ts = [], []
            for k in range(SESSION_WARM):
                # in turns, the order swapped every turn
                pair_ = [(ex_ts, lambda: card.sql(run_, pctx)),
                         (lit_ts, lambda: card.sql(literal))]
                for ts_, fn in (pair_[::-1] if k % 2 else pair_):
                    ts_.append(walls_one(fn))
            execute[f"hour_{h}"] = {
                "rows": got.num_rows, "g_launches": g_n,
                "execute_warm_ms_median": float(np.median(ex_ts)),
                "literal_warm_ms_median": float(np.median(lit_ts)),
                "overhead_ms": float(np.median(ex_ts) - np.median(lit_ts)),
                "execute_warm_ms": ex_ts, "literal_warm_ms": lit_ts,
            }
        card.execute_sql("DEALLOCATE g", pctx)
        try:
            card.sql("EXECUTE g (0, 3600000)", pctx)
        except InvalidArgumentError as e:
            if str(e) != "prepared statement 'g' does not exist":
                raise
        else:
            raise AssertionError("session: EXECUTE after DEALLOCATE ran")
        out["execute"] = execute
        out["execute_seconds"] = time.perf_counter() - t_part
        emit({"session_execute": execute})

        # ---- ADMIN kill of a statement running on the card -----------
        t_part = time.perf_counter()
        leaf = SESSION_LITERAL.format(lo=0, hi=HOUR_MS)
        card.sql(leaf)
        leaf_ms, _ = walls(lambda: card.sql(leaf))
        state = {}

        def victim():
            try:
                state["res"] = card.sql(victim_sql, QueryContext())
            except ExecutionError as e:
                state["raised"] = time.perf_counter()
                state["err"] = str(e)

        th = threading.Thread(target=victim, name="session-victim")
        th.start()
        pid, polls = None, 0
        while pid is None:
            procs = card.sql("SHOW PROCESSLIST")
            polls += 1
            for row in procs.rows():
                doc = dict(zip(procs.names, row))
                if doc["Info"] == "SetOp" and doc["State"] == "Running":
                    pid = doc["Id"]
            if pid is None and not th.is_alive():
                raise AssertionError("session kill: the victim ended "
                                     "before it was seen running")
        t_kill = time.perf_counter()
        ack = card.sql(f"ADMIN kill('{pid}')").rows()
        th.join(600)
        if ack != [[1]]:
            raise AssertionError(f"session kill: ADMIN kill answered {ack}")
        if "err" not in state:
            raise AssertionError("session kill: the victim ended before the "
                                 "kill landed")
        if state["err"] != f"query {pid} was killed":
            raise AssertionError(f"session kill: {state['err']}")
        if card._process_list.snapshot():
            raise AssertionError("session kill: the process list kept an "
                                 "entry")
        kill_ms = (state["raised"] - t_kill) * 1e3
        # the victim whole (its later leaves' scans cold), then once warm
        whole = card.sql(victim_sql)
        cpu0 = ref.seconds
        same_window_result("session victim vs cpu", whole,
                           ref.got(asked["victim"]))
        victim_cpu_s = ref.seconds - cpu0
        victim_ms = walls_one(lambda: card.sql(victim_sql))
        out["kill"] = {"polls_until_running": polls, "kill_to_raise_ms":
                       kill_ms, "leaf_warm_ms_median": leaf_ms,
                       "victim_rows": whole.num_rows, "victim_leaves":
                       args.hours, "victim_warm_ms": victim_ms,
                       "cpu_port_seconds": victim_cpu_s,
                       "seconds": time.perf_counter() - t_part}
        emit({"session_kill": out["kill"]})

        # ---- information_schema and pg_catalog, in process and HTTP --
        t_part = time.perf_counter()
        srv = HttpServer(card, port=0).start()
        system = {}
        for name, q in SESSION_SYSTEM.items():
            got = card.sql(q)
            if got.num_rows == 0:
                raise AssertionError(f"session {name}: no rows")
            same_window_result(f"session {name} vs cpu", got,
                               ref.got(asked["system", name]))
            doc = http_sql(srv.port, q)
            want = json.loads(json.dumps({"output": [result_to_json(got)]}))
            if doc != want:
                raise AssertionError(f"session {name}: /v1/sql differs from "
                                     f"the in-process answer")
            ms, ts = walls(lambda: card.sql(q))
            system[name] = {"rows": got.num_rows, "warm_ms_median": ms,
                            "warm_ms": ts}
        out["system_tables"] = system
        out["system_seconds"] = time.perf_counter() - t_part
        emit({"session_system_tables": system})

        # ---- SET and SHOW VARIABLES on one session --------------------
        ctx = QueryContext()
        card.execute_sql("SET time_zone = '+08:00'", ctx)
        card.execute_sql("SET SESSION read_preference = 'leader'", ctx)
        got = [card.sql(f"SHOW VARIABLES LIKE '{v}'", ctx).rows()
               for v in ("time_zone", "read_preference")]
        if got != [[["time_zone", "+08:00"]],
                   [["read_preference", "leader"]]] or \
                ctx.timezone != "+08:00":
            raise AssertionError(f"session SET: {got}, {ctx.timezone}")
    finally:
        if srv is not None:
            srv.stop()
        for inst in insts:
            inst.close()
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    launches = counts()
    out["launches"] = launches
    # the worker's seconds on these answers, and the time the phase
    # waited for them (the worker builds its table while 14 and 15 run)
    out["cpu_reference_seconds"] = ref.seconds
    out["cpu_reference_wait_seconds"] = ref.waited
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "session", **{k: v for k, v in out.items() if k not in (
        "explain", "execute", "kill", "system_tables")}})
    return launches


# ---- phase 17: poll ----------------------------------------------------

# P1: Q2's SQL text (RANGE 2h ALIGN 1h BY region, through K2); P2: the
# per-host dashboard panel (4,000 hosts x 720 one-minute cells)
POLL_QUERIES = {
    "P1": SESSION_Q2,
    "P2": ("SELECT ts, hostname, avg(usage_user) RANGE '1m' FROM cpu "
           "ALIGN '1m' BY (hostname)"),
}
# another RANGE query through K2 between two polls of P1 (the session's
# buffer must not alias memory its launches write)
POLL_OTHER = ("SELECT ts, region, sum(usage_system) RANGE '1h', "
              "max(usage_idle) RANGE '1h' FROM cpu ALIGN '1h' BY (region)")
POLL_WARM = 3           # warm runs of each timing (median)
POLL_CLIENTS = 8        # client threads polling P1 under the limit
POLL_USERS = {"grafana": "grafana-pw", "noisy": "noisy-pw"}
POLL_TIMEOUT_S = 0.5    # the deadline on phase 16's victim (s)


def poll_insert(args, region_of) -> str:
    """The next minute after the table's last (six samples at 10 s) of
    usage_user for every host, as one INSERT (the other fields NULL)."""
    rng = np.random.default_rng(args.seed + 17)
    t0 = args.hours * HOUR_MS
    vals = rng.random((6, args.hosts)) * 100.0
    return "INSERT INTO cpu (ts, hostname, region, usage_user) VALUES " + \
        ", ".join(f"({t0 + k * STEP_MS}, 'host_{h}', '{region_of[h]}', "
                  f"{float(vals[k, h])!r})"
                  for k in range(6) for h in range(args.hosts))


def poll_http(port, text, user, pwd, extra=""):
    """(status, answer) of /v1/sql with basic auth; the answer without its
    timing field."""
    import base64
    import urllib.parse

    tok = base64.b64encode(f"{user}:{pwd}".encode()).decode()
    status, body, _ = http_call(
        port, "/v1/sql" + extra,
        urllib.parse.urlencode({"sql": text}).encode(),
        {"Content-Type": "application/x-www-form-urlencoded",
         "Authorization": f"Basic {tok}"})
    doc = json.loads(body)
    doc.pop("execution_time_ms", None)
    return status, doc


def ts_steps(res) -> np.ndarray:
    """The distinct step timestamps of a RANGE answer."""
    return np.unique(np.asarray(res.cols[0].values, np.int64))


def rows_after(res, cut):
    """The rows of `res` whose ts is past `cut`, as columns."""
    from types import SimpleNamespace

    keep = np.asarray(res.cols[0].values, np.int64) > cut
    return SimpleNamespace(
        names=res.names, num_rows=int(keep.sum()),
        cols=[SimpleNamespace(values=np.asarray(c.values)[keep],
                              valid_mask=np.asarray(c.valid_mask)[keep])
              for c in res.cols])


def poll_phase(args, dev, window_out, wref):
    """Phase 17 (see the module docstring); `wref` is the CPU reference
    worker. Returns the launches of the kernels its polls ran."""
    import shutil
    import tempfile
    import threading

    from greptimedb_tpu_torch.auth import StaticUserProvider
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss
    from greptimedb_tpu_torch.query import device_range as dr
    from greptimedb_tpu_torch.query import readback, sessions
    from greptimedb_tpu_torch.query.result_cache import ResultCache
    from greptimedb_tpu_torch.sched import (
        AdmissionController,
        SchedulerConfig,
    )
    from greptimedb_tpu_torch.servers.http import HttpServer
    from greptimedb_tpu_torch.session import QueryContext

    t_phase = time.perf_counter()
    table = window_out["table"]
    out = {"rows": int(table.row_count())}
    mods = {"grouped_block_reduce": gr, "blocked_fold_sum": rf,
            "gather_planes": mg, "segmented_scan": ss}
    ref = RefCalls(wref)

    def counts():
        return {n: getattr(m, n).launches for n, m in mods.items()}

    # runs of the range program (its body, around K2), observed
    programs = [0]
    real_body = dr._range_body

    def counted_body(*a, **k):
        programs[0] += 1
        return real_body(*a, **k)

    def observe(fn):
        """fn()'s answer and its wall, kernel launches, range programs
        and readback bytes."""
        c0, p0, r0 = counts(), programs[0], dict(readback.readback_bytes)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {
            "ms": (time.perf_counter() - t) * 1e3,
            "launches": {n: c - c0[n] for n, c in counts().items()},
            "programs": programs[0] - p0,
            "readback": {k: v - r0[k]
                         for k, v in readback.readback_bytes.items()}}

    def since(v):
        ctx = QueryContext()
        ctx.extensions["since_ms"] = int(v)
        return ctx

    def fail(what):
        raise AssertionError(f"poll {what}")

    root = tempfile.mkdtemp(prefix="chip_smoke_poll_")
    card = srv = None
    try:
        dr._range_body = counted_body
        sessions.configure({"enable": True})
        card = Standalone(root, device=dev, prefer_device=True,
                          warm_start=False)
        card.catalog.register(table)
        # the result cache as the JAX package's tests enable it
        rc = ResultCache.from_options({"enable": True})
        card.result_cache = card.catalog.result_cache = rc
        eng = card.query_engine
        for n, m in mods.items():
            getattr(m, n).launches = 0
        first = {}
        polls = {}
        for name, q in POLL_QUERIES.items():
            st = polls[name] = {}
            rc.enabled = False
            # 1. cold (the grid's build), then warm misses: the program on
            # the cached grid, sessions off for them
            res, o = observe(lambda: card.sql(q))
            if eng.last_exec_path != "device" or eng.last_session != "miss":
                fail(f"{name} cold: {eng.last_exec_path} "
                     f"{eng.last_session}")
            first[name] = res
            st["cold"] = o
            sessions.global_sessions.enabled = False
            misses = [observe(lambda: card.sql(q)) for _ in range(POLL_WARM)]
            sessions.global_sessions.enabled = True
            # 2. session hits: no range program, no K2
            hits = [observe(lambda: card.sql(q)) for _ in range(POLL_WARM)]
            if eng.last_session != "hit":
                fail(f"{name} session: {eng.last_session}")
            for r, o in misses + hits:
                same_window_result(f"poll {name} warm", r, res)
            for r, o in misses:
                if o["programs"] != 1:
                    fail(f"{name} warm miss ran {o['programs']} programs")
            for r, o in hits:
                if o["programs"] or any(o["launches"].values()):
                    fail(f"{name} session hit launched {o}")
            if name == "P1" and not all(o["launches"]["blocked_fold_sum"]
                                        for _, o in misses):
                fail("P1 warm miss without K2")
            st["warm_miss"] = [o for _, o in misses]
            st["session_hit"] = [o for _, o in hits]
            # 3. the result cache: the first poll stores, then hits with
            # no launch and no readback
            rc.enabled = True
            h0 = rc.hits
            _, st["cache_store"] = observe(lambda: card.sql(q))
            cached = [observe(lambda: card.sql(q)) for _ in range(POLL_WARM)]
            if rc.hits - h0 != POLL_WARM:
                fail(f"{name} result cache hits {rc.hits - h0}")
            for r, o in cached:
                same_window_result(f"poll {name} cached", r, res)
                if o["programs"] or any(o["launches"].values()) or any(
                        o["readback"].values()):
                    fail(f"{name} cache hit ran {o}")
            st["cache_hit"] = [o for _, o in cached]
            # 4. `since` at the step before the last (cache off): one
            # step's bytes, beside a full poll's (both session hits)
            rc.enabled = False
            steps = ts_steps(res)
            _, full = observe(lambda: card.sql(q))
            delta, o = observe(lambda: card.sql(q, since(steps[-2])))
            nbytes = full["readback"]["full"]
            if nbytes % len(steps) or o["readback"] != {
                    "full": 0, "delta": nbytes // len(steps)}:
                fail(f"{name} delta bytes {o['readback']} beside full "
                     f"{nbytes} over {len(steps)} steps")
            same_window_result(f"poll {name} since", delta,
                               rows_after(res, steps[-2]))
            st["full_poll"], st["since_poll"] = full, o
            st["readback_full_bytes"] = nbytes
            st["readback_delta_bytes"] = o["readback"]["delta"]
            st["rows"], st["steps"] = res.num_rows, len(steps)
        # the aliasing check: P1 again after another query through K2
        _, o = observe(lambda: card.sql(POLL_OTHER))
        if not o["launches"]["blocked_fold_sum"]:
            fail("the other query did not launch K2")
        again, o = observe(lambda: card.sql(POLL_QUERIES["P1"]))
        if eng.last_session != "hit" or o["programs"]:
            fail("P1 after the other query was not a session hit")
        same_window_result("poll P1 after another K2 query", again,
                           first["P1"])
        out["aliasing_check"] = "bit-identical"

        # 5. the next minute for every host: both caches miss, the
        # program runs again, the answers equal the CPU port's
        ins = poll_insert(args, window_out["region_of"])
        ref_ins = ref.ask(ins)
        asked = {name: ref.ask(q) for name, q in POLL_QUERIES.items()}
        rc.enabled = True
        _, out["insert"] = observe(lambda: card.execute_sql(ins))
        for name, q in POLL_QUERIES.items():
            st = polls[name]
            m0 = rc.misses
            after, o = observe(lambda: card.sql(q))
            if rc.misses != m0 + 1 or eng.last_session != "miss" or \
                    o["programs"] != 1:
                fail(f"{name} after the insert: misses {rc.misses - m0}, "
                     f"session {eng.last_session}, {o}")
            if name == "P1" and not o["launches"]["blocked_fold_sum"]:
                fail("P1 after the insert without K2")
            st["after_insert"] = o
            if name == "P1":
                ref.got(ref_ins)
            want = ref.got(asked[name])
            if name == "P1":
                st["max_abs_diff_vs_cpu"] = compare_results(
                    "poll P1 after the insert", after, want,
                    {"count", "sum", "min", "max", "avg", "stddev_samp",
                     "first_value", "last_value"}, 2 * HOUR_MS // STEP_MS)
            else:
                st["identical_to_cpu"], st["max_rel_diff_vs_cpu"] = \
                    compare_engines("poll P2 after the insert", want, after,
                                    60_000 // STEP_MS,
                                    bounded=(after.names[2],))
            old = ts_steps(first[name])
            new_steps = ts_steps(after)
            delta, o = observe(lambda: card.sql(q, since(old[-1])))
            if set(ts_steps(delta).tolist()) != set(
                    new_steps[new_steps > old[-1]].tolist()):
                fail(f"{name} since after the insert: steps "
                     f"{ts_steps(delta)[:3]}")
            same_window_result(f"poll {name} since after the insert", delta,
                               rows_after(after, old[-1]))
            st["since_after_insert"] = o
            st["new_steps"] = int((new_steps > old[-1]).sum())
        out["cpu_reference_seconds"] = ref.seconds
        out["cpu_reference_wait_seconds"] = ref.waited
        out["polls"] = polls

        # ---- admission over /v1/sql with basic auth -------------------
        t_part = time.perf_counter()
        rc.enabled = False      # every statement below runs for real
        card.scheduler = AdmissionController(SchedulerConfig(
            max_concurrency=2, queue_timeout_s=120.0,
            tenants={"noisy": {"qps": 1.0, "burst": 1.0}}))
        srv = HttpServer(card, port=0, user_provider=StaticUserProvider(
            POLL_USERS)).start()
        p1 = POLL_QUERIES["P1"]
        status, single = poll_http(srv.port, p1, "grafana",
                                   POLL_USERS["grafana"])
        if status != 200:
            fail(f"P1 over HTTP: {status} {single}")
        # queueing: both slots held (the controller's own acquire, as a
        # statement takes one), eight clients wait "Queued"
        for _ in range(2):
            card.scheduler._acquire("operator", None)
        answers, walls_ = [None] * POLL_CLIENTS, [None] * POLL_CLIENTS

        def client(i):
            t = time.perf_counter()
            answers[i] = poll_http(srv.port, p1, "grafana",
                                   POLL_USERS["grafana"])
            walls_[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(POLL_CLIENTS)]
        for th in threads:
            th.start()
        queued, t_wait = 0, time.perf_counter()
        try:
            while queued < POLL_CLIENTS and \
                    time.perf_counter() - t_wait < 60:
                procs = card.sql("SHOW PROCESSLIST")
                queued = sum(1 for row in procs.rows()
                             if dict(zip(procs.names, row))["State"]
                             == "Queued")
        finally:
            for _ in range(2):
                card.scheduler._release("operator")
        for th in threads:
            th.join(600)
        if queued != POLL_CLIENTS:
            fail(f"SHOW PROCESSLIST saw {queued} Queued statements")
        if any(a != (200, single) for a in answers):
            fail("a queued client's answer differs from the single one")
        admission = {"queued_seen": queued,
                     "client_wall_ms": walls_,
                     "max_concurrency": 2}
        # a deadline: timeout=0.5 on phase 16's victim (a scan and so a
        # checkpoint a leaf), all warm, answers 503 within a leaf of it
        victim = session_victim(args.hours)
        card.sql(victim)
        leaves = [walls_one(lambda h=h: card.sql(SESSION_LITERAL.format(
            lo=h * HOUR_MS, hi=(h + 1) * HOUR_MS).replace(
                " ORDER BY hostname", ""))) for h in range(args.hours)]
        t = time.perf_counter()
        status, doc = poll_http(srv.port, victim, "grafana",
                                POLL_USERS["grafana"],
                                f"?timeout={POLL_TIMEOUT_S}")
        late = time.perf_counter() - t - POLL_TIMEOUT_S
        if status != 503 or "deadline" not in doc.get("error", ""):
            fail(f"the deadline answered {status} {doc}")
        if late > max(leaves) / 1e3 + 0.1:
            fail(f"the deadline's answer came {late:.3f} s late; the "
                 f"largest leaf takes {max(leaves) / 1e3:.3f} s")
        admission["deadline"] = {"timeout_s": POLL_TIMEOUT_S,
                                 "status": status,
                                 "late_s": late, "leaf_warm_ms": leaves,
                                 "error": doc["error"]}
        # quotas: noisy (1 qps) is shed while grafana completes
        tenants = [poll_http(srv.port, "SELECT 1", *pair)[0] for pair in (
            ("noisy", POLL_USERS["noisy"]), ("noisy", POLL_USERS["noisy"]),
            ("grafana", POLL_USERS["grafana"]))]
        if tenants != [200, 429, 200]:
            fail(f"quota statuses {tenants}")
        # auth: a wrong password
        wrong = poll_http(srv.port, "SELECT 1", "grafana", "nope")[0]
        if wrong != 401:
            fail(f"a wrong password answered {wrong}")
        admission.update({"quota_statuses": tenants,
                          "wrong_password_status": wrong,
                          "shed": {"/".join(k): v for k, v in
                                   card.scheduler.shed.items()},
                          "seconds": time.perf_counter() - t_part})
        out["admission"] = admission
    finally:
        dr._range_body = real_body
        sessions.configure({"enable": False})
        if srv is not None:
            srv.stop()
        if card is not None:
            card.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = counts()
    out["launches"] = launches
    out["sessions"] = {"hits": sessions.global_sessions.hits,
                       "misses": sessions.global_sessions.misses}
    out["result_cache"] = {"hits": rc.hits, "misses": rc.misses}
    out["seconds"] = time.perf_counter() - t_phase
    for name, st in out["polls"].items():
        emit({"poll": name, **{k: v for k, v in st.items()
                               if k not in ("warm_miss", "session_hit",
                                            "cache_hit")},
              "warm_miss_ms_median": float(np.median(
                  [o["ms"] for o in st["warm_miss"]])),
              "session_hit_ms_median": float(np.median(
                  [o["ms"] for o in st["session_hit"]])),
              "cache_hit_ms_median": float(np.median(
                  [o["ms"] for o in st["cache_hit"]]))})
    emit({"poll_admission": out["admission"]})
    emit({"phase": "poll", **{k: v for k, v in out.items()
                              if k not in ("polls", "admission")}})
    return launches


# ---- phase 18: index --------------------------------------------------

# phase 7's prom_bench labels are host_i and dc = "dc{i % 32}": the four
# matcher sets as PromQL selector text and as registry matchers
INDEX_SETS = {
    "dc_eq": ('dc="dc3"', [("dc", "eq", "dc3")]),
    "dc_re": ('dc=~"dc(1|2)"', [("dc", "re", "dc(1|2)")]),
    "host_re": ('host=~"host_1.*"', [("host", "re", "host_1.*")]),
    "neg": ('dc!="dc0", host!~"host_9.*"',
            [("dc", "ne", "dc0"), ("host", "nre", "host_9.*")]),
}
INDEX_QUERIES = ("sum by (dc) (rate(prom_bench{{{m}}}[1m]))",
                 "topk(5, rate(prom_bench{{{m}}}[1m]))")
INDEX_WARM = 3
# bench.py's index probe (bench.py:4333-4357): 12 SSTs of 500 fresh hosts
# x 12 points, and a regex over 1.2 M series at 2,000 and 20,000 values
IDX_BATCHES = 12
IDX_HOSTS_PER_BATCH = 500
IDX_POINTS = 12
IDX_CARD_SERIES = 1_200_000
IDX_CARDS = (2_000, 20_000)
# the log table: 4 flushes of 270,000 access-log lines (two row groups of
# the default 262,144 rows each), 16 web servers, a line every 10 ms
LOG_SSTS = 4
LOG_ROWS = 270_000
LOG_HOSTS = 16
LOG_T0 = 1_700_000_000_000
LOG_STEP_MS = 10
LOG_RARE_SST = 2        # the only flush with "/wp_login.php" lines
LOG_PATHS = ("/", "/index.html", "/robots.txt", "/favicon.ico",
             "/static/app.js", "/static/site.css", "/img/logo.png",
             "/api/v1/items", "/api/v1/orders", "/search", "/login",
             "/cart", "/checkout", "/blog/2023/tsdb", "/docs/install")
LOG_USERS = ("-", "-", "-", "-", "alice", "bob", "carol", "dave")
LOG_STATUS = (200, 200, 200, 200, 200, 304, 301, 404, 403, 500)
LOG_UA = ("curl/8.4.0", "Mozilla/5.0", "Googlebot/2.1", "python/3.12")
LOG_QUERIES = {
    "present": ("wp_login", {"ssts_pruned_fulltext": 3,
                             "row_groups_pruned_fulltext": 1}),
    "absent": ("xmlrpc", {"ssts_pruned_fulltext": 4}),
    "or": ("wp_login OR robots", {}),
    "phrase": ('"POST /wp_login.php HTTP"',
               {"ssts_pruned_fulltext": 3, "row_groups_pruned_fulltext": 1}),
}
LOG_FUNCS = (
    "SELECT ts, host, ipv4_string_to_num(client), "
    "ipv4_in_range(client, '10.0.0.0/8'), ipv4_num_to_string(bytes), "
    "json_get_int(attrs, '$.status'), json_get_string(attrs, '$.ua'), "
    "json_get_float(attrs, '$.rt'), json_path_exists(attrs, '$.ref'), "
    "json_is_object(attrs), st_distance(lat, lon, 37.7749, -122.4194), "
    "geohash(lat, lon, 6), h3_latlng_to_cell(lat, lon, 8), "
    "st_point(lat, lon) FROM access_log WHERE ts < {cut} "
    "ORDER BY host, ts")
LOG_FUNC_ROWS = 1000


def same_bits(a, b) -> bool:
    """Two PromQL vectors bit for bit at their own dtype: labels in
    order, presence and every present value."""
    if a.labels != b.labels or not np.array_equal(a.present, b.present):
        return False
    va, vb = a.values[a.present], b.values[b.present]
    return va.dtype == vb.dtype and bool(np.array_equal(
        va.view(f"u{va.dtype.itemsize}"), vb.view(f"u{vb.dtype.itemsize}")))


def index_sets():
    """INDEX_SETS' registry matchers with their regexes compiled as the
    PromQL engine compiles them."""
    from greptimedb_tpu_torch.query.expr import compile_matcher

    return {name: [(t, op, compile_matcher(v) if op in ("re", "nre")
                    else v) for t, op, v in m]
            for name, (_, m) in INDEX_SETS.items()}


_IREF_POOL = []


def start_index_reference(args):
    """Phase 18's host-only work in a worker process, started after phase
    7 so that it runs beside phases 8 to 17: the port on the CPU
    over phase 7's prom_bench rows (18a's references), the 1.2 M-series
    cardinality probe (18b) and the port on the CPU over the access log
    (18c's references). stop_index_reference stops it."""
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(1)
    _IREF_POOL.append(pool)
    # in the order phase 18 reads them
    return {"prom": pool.apply_async(prom_cpu_reference,
                                     (args.prom_series,)),
            "probe": pool.apply_async(cardinality_probe),
            "logs": pool.apply_async(log_cpu_reference, (args.seed,))}


def stop_index_reference(clean: bool = True):
    while _IREF_POOL:
        pool = _IREF_POOL.pop()
        if clean:
            pool.close()
        else:
            pool.terminate()
        pool.join()


def prom_cpu_reference(n):
    """The port on the CPU (x64, as phase 7's engines) over prom_bench's
    n series: every 18a query's answer, and the seconds it took."""
    import types

    from greptimedb_tpu_torch.catalog.manager import CatalogManager
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.promql.engine import PromEngine
    from greptimedb_tpu_torch.query import sessions
    from greptimedb_tpu_torch.query.executor import QueryEngine

    torch.set_num_threads(4)
    sessions.configure({"enable": False})
    t = time.perf_counter()
    table = Table("prom_bench", ts_name="ts", tag_names=["host", "dc"],
                  fields=["greptime_value"])
    prom_ingest(table, n)
    catalog = CatalogManager()
    catalog.register(table)
    eng = PromEngine(types.SimpleNamespace(catalog=catalog,
                                           query_engine=QueryEngine(
                                               device="cpu", x64=True)))
    res = {key: eng.query_range(q, *PROM_SPAN)[0]
           for key, q in index_queries().items()}
    return res, time.perf_counter() - t


def cardinality_probe():
    """18b's first half (host code only): TagIndex.match_sids of
    v17(00)? over 1.2 M series against the registry's linear match, at
    2,000 and at 20,000 host values."""
    import re

    from greptimedb_tpu_torch.index import tag_index
    from greptimedb_tpu_torch.storage.series import SeriesRegistry

    # one registry of 1.2 M series holds both host columns (bench.py
    # builds one registry a cardinality; the interning is the cost)
    t = time.perf_counter()
    reg = SeriesRegistry([f"host_{c}" for c in IDX_CARDS] + ["id"])
    reg.intern_rows(
        [np.asarray([f"v{i % c}" for i in range(IDX_CARD_SERIES)], object)
         for c in IDX_CARDS]
        + [np.asarray([f"s{i}" for i in range(IDX_CARD_SERIES)], object)])
    card = {"intern_s": time.perf_counter() - t}
    ix = tag_index.TagIndex(reg)
    for c in IDX_CARDS:
        m = [(f"host_{c}", "re", re.compile(r"v17(00)?"))]
        t = time.perf_counter()
        got = ix.match_sids(m)          # the first builds the postings
        cold_ms = (time.perf_counter() - t) * 1e3
        want = reg.match_sids(m)
        if got.dtype != np.int32 or not np.array_equal(got, want):
            raise AssertionError(f"index: postings differ from the linear "
                                 f"match at {c} values")
        ix_ms, lin_ms = [], []
        for _ in range(3):
            ix._results.clear()     # evaluate, not the result cache
            t = time.perf_counter()
            ix.match_sids(m)
            ix_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            reg.match_sids(m)
            lin_ms.append((time.perf_counter() - t) * 1e3)
        card[c] = {"cold_ms": cold_ms, "index_ms": min(ix_ms),
                   "linear_ms": min(lin_ms), "matched": int(len(got))}
    return card


def index_queries() -> dict:
    """18a's queries by (matcher set, query)."""
    return {(s, j): t.format(m=sel)
            for s, (sel, _) in INDEX_SETS.items()
            for j, t in enumerate(INDEX_QUERIES)}


def plane_part(dev, prom_out, iref, out):
    """18a: the four matcher sets on phase 7's 1 M series, plane on and
    off, one device and the four-shard ring, against the CPU port; then
    per set what the mask moves and costs on each path."""
    from greptimedb_tpu_torch.index import device_plane, tag_index
    from greptimedb_tpu_torch.promql import fast as TF

    engines = {k: prom_out["engines"][k] for k in ("single", "ring")}
    queries = index_queries()

    def entry_of(eng):
        # phase 7's cached grids: one device, and the ring's (mesh, no
        # mesh options; the gather twin's carry kernels off)
        return next(e for k, e in TF._CACHE._entries.items()
                    if k[2] == str(dev) and k[4] is None
                    and (k[3] is None) == (eng == "single"))

    def clear_masks():
        for e in TF._CACHE._entries.values():
            e.match_cache.clear()
        device_plane.invalidate()

    res, walls, paths = {}, {}, {}
    for mode in ("plane", "host"):
        tag_index.configure({"device_plane": mode == "plane"})
        clear_masks()
        for eng_name, eng in engines.items():
            for key, q in queries.items():
                p0, l0 = device_plane.stats(), tag_index.lookup_counts()
                t = time.perf_counter()
                res[mode, eng_name, key] = eng.query_range(q, *PROM_SPAN)[0]
                torch.cuda.synchronize()
                cold = (time.perf_counter() - t) * 1e3
                p1, l1 = device_plane.stats(), tag_index.lookup_counts()
                warm = [walls_one(lambda: eng.query_range(q, *PROM_SPAN))
                        for _ in range(INDEX_WARM)]
                p2 = device_plane.stats()
                if p2["ok_upload_bytes"] != p1["ok_upload_bytes"] or \
                        p2["plane_upload_bytes"] != p1["plane_upload_bytes"]:
                    raise AssertionError(f"index: a repeated {q} uploaded")
                walls[mode, eng_name, key] = {
                    "cold_ms": cold, "warm_median_ms": float(np.median(warm))}
                moved = {k: p1[k] - p0[k] for k in (
                    "builds", "build_ms", "plane_upload_bytes",
                    "mask_misses", "ok_upload_bytes")}
                moved["host_lookups"] = sum(l1.values()) - sum(l0.values())
                paths[mode, eng_name, key] = moved
                # the set's first query makes its mask: on the plane with
                # the plane on, through the index on the host without it
                if key[1] == 0:
                    on_plane = moved["mask_misses"] == 1
                    if on_plane != (mode == "plane") or (
                            mode == "host" and not moved["host_lookups"]):
                        raise AssertionError(
                            f"index: {q} on {eng_name} took the wrong mask "
                            f"path with the plane {mode}: {moved}")
    tag_index.configure({"device_plane": True})
    # ---- answers: plane = host mask bit for bit; engines agree as phase
    # 7's do; one device = the CPU port (topk exact, the aggregate within
    # phase 7's matrix-product bound)
    t = time.perf_counter()
    cpu_res, cpu_s = iref["prom"].get(timeout=900)
    waited = time.perf_counter() - t
    bound_per = 2 * prom_out["gamma"] * prom_out["max_rate"]
    agg_rel = 0.0
    for key, q in queries.items():
        for eng_name in engines:
            if not same_bits(res["plane", eng_name, key],
                             res["host", eng_name, key]):
                raise AssertionError(f"index: plane and host masks answer "
                                     f"{q} differently on {eng_name}")
        if not same_vector(res["plane", "single", key],
                           res["plane", "ring", key]):
            raise AssertionError(f"index: ring differs from one device on "
                                 f"{q}")
        a, c = res["plane", "single", key], cpu_res[key]
        if key[1] == 1:
            if not same_vector(a, c):
                raise AssertionError(f"index: {q} differs from the CPU port")
            continue
        if a.labels != c.labels or not np.array_equal(a.present, c.present):
            raise AssertionError(f"index: {q}'s groups differ from the CPU")
        members = np.asarray([prom_out["members"][int(lb["dc"][2:])]
                              for lb in a.labels])
        diff = np.abs(a.values - c.values)
        if not np.all(diff <= bound_per * members[:, None]):
            raise AssertionError(f"index: {q} past the matrix-product bound")
        if a.present.any():
            agg_rel = max(agg_rel, float(np.max(
                diff[a.present] / np.abs(c.values[a.present]))))
    # ---- per set: what the mask moves and costs on each path ---------
    sets = index_sets()
    per_set = {}
    for name, m in sets.items():
        row = {}
        for eng_name in engines:
            entry = entry_of(eng_name)
            p = device_plane._get_plane(entry.registry, entry.s_pad,
                                        entry.devices)
            cols, oks = device_plane._ok_tables(p, entry.registry, m)
            oks_dev = [torch.from_numpy(ok).to(dev) for ok in oks]

            def gather(p=p, cols=cols, oks_dev=oks_dev):
                for c in p.dev_codes:
                    device_plane._gather_and(c, cols, oks_dev)

            def plane_call(p=p, entry=entry, m=m):
                p.mask_cache.clear()
                device_plane.matcher_mask_dev(
                    entry.registry, m, entry.s_pad, devices=entry.devices,
                    num_series=entry.num_series)

            ix = tag_index.index_for(entry.registry)

            def host_mask(ix=ix, entry=entry, m=m):
                ix._results.clear()
                mask = np.zeros(entry.s_pad, bool)
                mask[:entry.num_series] = tag_index.match_mask(
                    entry.registry, m)
                return mask

            mask = host_mask()
            s0 = device_plane.stats()
            plane_call()
            again = device_plane.matcher_mask_dev(
                entry.registry, m, entry.s_pad, devices=entry.devices,
                num_series=entry.num_series)
            s1 = device_plane.stats()
            if s1["mask_hits"] != s0["mask_hits"] + 1 or \
                    s1["ok_upload_bytes"] != s0["ok_upload_bytes"] + sum(
                        ok.nbytes for ok in oks):
                raise AssertionError(f"index: set {name}'s repeat on "
                                     f"{eng_name} was no cache hit")
            got = torch.cat([t.cpu() for t in again[0]]).numpy()
            if not np.array_equal(got, mask):
                raise AssertionError(f"index: plane mask of {name} on "
                                     f"{eng_name} differs from the host's")
            row[eng_name] = {
                "ok_table_bytes": int(sum(ok.nbytes for ok in oks)),
                "ok_table_entries": [int(ok.size) for ok in oks],
                "s_pad_bytes": int(entry.s_pad),
                "matched": int(mask.sum()),
                "plane_gather_ms": cuda_ms(gather),
                "host_upload_ms": host_ms(
                    lambda entry=entry, mask=mask: (
                        TF._sharded(entry, mask),
                        torch.cuda.synchronize()), reps=5, warm=1),
            }
            if eng_name == "single":
                # the host work of both paths (the regex over the distinct
                # values runs in each), three calls each
                row[eng_name]["plane_call_ms"] = host_ms(plane_call, reps=3,
                                                         warm=0)
                row[eng_name]["host_mask_ms"] = host_ms(host_mask, reps=3,
                                                        warm=0)
        per_set[name] = row
    builds = {eng_name: {k: paths["plane", eng_name, (s, j)][k]
                         for k in ("build_ms", "plane_upload_bytes")}
              for eng_name in engines
              for s, j in [next(iter(queries))]}
    out["plane"] = {
        "queries": {f"{mode}/{eng}/{queries[key]}": {
            **walls[mode, eng, key], "moved": paths[mode, eng, key]}
            for mode, eng, key in walls},
        "per_set": per_set, "plane_builds": builds,
        "cpu_reference_worker_s": cpu_s, "cpu_reference_waited_s": waited,
        "agg_max_rel_diff_vs_cpu": agg_rel,
        "checks": {"plane_equals_host_mask": True, "engines_identical": True,
                   "equals_cpu_port": True, "repeat_uploads_nothing": True}}


def index_probe_part(dev, iref, out):
    """18b: the tag index at bench.py's index-probe shapes: the worker's
    cardinality probe, then pruned SQL on the card."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.index import tag_index
    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.query.executor import QueryResult

    t = time.perf_counter()
    card = iref["probe"].get(timeout=900)
    card["waited_s"] = time.perf_counter() - t
    root = tempfile.mkdtemp(prefix="chip_smoke_index_")
    inst = None
    try:
        inst = Standalone(root, device=dev, warm_start=False)
        inst.sql("create table idxt (ts timestamp time index, "
                 "host string primary key, v double)")
        table = inst.catalog.table("public", "idxt")
        for b in range(IDX_BATCHES):
            hosts = np.repeat(np.asarray(
                [f"b{b}_h{i}" for i in range(IDX_HOSTS_PER_BATCH)], object),
                IDX_POINTS)
            ts = (np.tile(np.arange(IDX_POINTS, dtype=np.int64) * 1000,
                          IDX_HOSTS_PER_BATCH) + b)
            table.write({"host": hosts}, ts,
                        {"v": np.arange(len(ts), dtype=np.float64)})
            table.flush()
        target = f"b{IDX_BATCHES // 2}_h7"
        qs = {"plain": f"SELECT ts, host, v FROM idxt WHERE host = "
                       f"'{target}' ORDER BY ts",
              "groupby": f"SELECT host, sum(v), count(*) FROM idxt WHERE "
                         f"host = '{target}' GROUP BY host"}
        sql = {}
        for name, q in qs.items():
            got = inst.sql(q)
            _, rows, notes = explain_parts(inst.sql(f"EXPLAIN ANALYZE {q}"))
            if notes.get("scan_path") != "index_pruned" or \
                    float(notes.get("index_pruned_bytes", 0)) <= 0:
                raise AssertionError(f"index: {name} notes {notes}")
            warm = [walls_one(lambda q=q: inst.sql(q)) for _ in range(3)]
            tag_index.configure({"enable": False})
            try:
                off = inst.sql(q)
                _, _, off_notes = explain_parts(
                    inst.sql(f"EXPLAIN ANALYZE {q}"))
                off_warm = [walls_one(lambda q=q: inst.sql(q))
                            for _ in range(3)]
            finally:
                tag_index.configure({"enable": True})
            if not isinstance(got, QueryResult) or rows != got.num_rows or \
                    list(got.names) != list(off.names) or not all(
                        same_column(a, b) for a, b in zip(got.cols,
                                                          off.cols)):
                raise AssertionError(f"index: {name} differs with the "
                                     f"index off")
            if off_notes.get("scan_path") != "full_scan":
                raise AssertionError(f"index off: {name} {off_notes}")
            sql[name] = {
                "rows": got.num_rows, "warm_median_ms": float(np.median(warm)),
                "warm_median_ms_index_off": float(np.median(off_warm)),
                **{k: notes[k] for k in notes if k.startswith(("index_",
                                                               "row_groups"))},
                "off": {k: off_notes[k] for k in off_notes
                        if k.startswith(("index_", "row_groups"))}}
    finally:
        if inst is not None:
            inst.close()
        shutil.rmtree(root, ignore_errors=True)
    out["probe"] = {"cardinality": card, "sql": sql,
                    "ssts": IDX_BATCHES,
                    "rows": IDX_BATCHES * IDX_HOSTS_PER_BATCH * IDX_POINTS}


def log_batch(rng, b):
    """One flush of the access log: LOG_ROWS lines shaped like Apache's
    common log format, with the client's address, status, size, a json
    attribute document and the client's coordinates as their own
    columns. Only flush LOG_RARE_SST holds "/wp_login.php" lines, all on
    the first web server."""
    n = LOG_ROWS
    i0 = b * n
    hosts = np.asarray([f"web_{j % LOG_HOSTS:02d}"
                        for j in range(i0, i0 + n)], object)
    ts = LOG_T0 + (np.arange(i0, i0 + n, dtype=np.int64) * LOG_STEP_MS)
    ip = rng.integers(0, 256, (n, 4))
    ip[:, 0] = rng.choice([10, 66, 172, 192, 203], n)
    client = np.asarray([f"{a}.{b_}.{c}.{d}" for a, b_, c, d in ip.tolist()],
                        object)
    users = np.asarray(LOG_USERS, object)[rng.integers(0, len(LOG_USERS), n)]
    paths = np.asarray(LOG_PATHS, object)[rng.integers(0, len(LOG_PATHS), n)]
    methods = np.where(rng.random(n) < 0.85, "GET", "POST").astype(object)
    if b == LOG_RARE_SST:
        rare = (np.arange(n) % LOG_HOSTS == 0) & (rng.random(n) < 0.05)
        paths[rare] = "/wp_login.php"
        methods[rare] = "POST"
    status = np.asarray(LOG_STATUS, np.int64)[
        rng.integers(0, len(LOG_STATUS), n)]
    size = rng.integers(0, 1 << 20, n).astype(np.int64)
    rt = np.round(rng.gamma(2.0, 0.05, n), 4)
    ua = np.asarray(LOG_UA, object)[rng.integers(0, len(LOG_UA), n)]
    stamps = np.datetime_as_string(ts.astype("datetime64[ms]"), unit="s")
    msg = np.asarray([
        f'{c} - {u} [{d}+0000] "{mt} {p} HTTP/1.1" {s} {z}'
        for c, u, d, mt, p, s, z in zip(
            client.tolist(), users.tolist(), stamps.tolist(),
            methods.tolist(), paths.tolist(), status.tolist(),
            size.tolist())], object)
    attrs = np.asarray([
        f'{{"status": {s}, "ua": "{a}", "rt": {r}}}' if j % 7 else
        f'{{"status": {s}, "ua": "{a}", "rt": {r}, "ref": "/"}}'
        for j, (s, a, r) in enumerate(zip(status.tolist(), ua.tolist(),
                                          rt.tolist()))], object)
    lat = np.round(rng.uniform(-60, 70, n), 4)
    lon = np.round(rng.uniform(-180, 180, n), 4)
    return ({"host": hosts}, ts,
            {"message": msg, "client": client, "status": status,
             "bytes": size, "lat": lat, "lon": lon, "attrs": attrs})


LOG_DDL = ("CREATE TABLE access_log (ts TIMESTAMP TIME INDEX, "
           "host STRING PRIMARY KEY, message STRING FULLTEXT, "
           "client STRING, status BIGINT, bytes BIGINT, lat DOUBLE, "
           "lon DOUBLE, attrs STRING) WITH (append_mode = 'true')")


def log_matches(query: str) -> str:
    return (f"SELECT count(*) FROM access_log WHERE matches(message, "
            f"'{query}')")


def write_logs(inst, seed) -> tuple:
    """The access log in `inst` (LOG_DDL), written and flushed a batch at
    a time from `seed`: (its region, the seconds of each step)."""
    inst.sql(LOG_DDL)
    table = inst.catalog.table("public", "access_log")
    region = table.regions[0]
    if region.meta.fulltext_fields != ["message"]:
        raise AssertionError(f"index: fulltext fields "
                             f"{region.meta.fulltext_fields}")
    rng = np.random.default_rng(seed + 18)
    seconds = {"generate": 0.0, "write": 0.0, "flush": 0.0}
    for b in range(LOG_SSTS):
        t = time.perf_counter()
        tags, ts, fields = log_batch(rng, b)
        seconds["generate"] += time.perf_counter() - t
        t = time.perf_counter()
        table.write(tags, ts, fields)
        seconds["write"] += time.perf_counter() - t
        t = time.perf_counter()
        table.flush()
        seconds["flush"] += time.perf_counter() - t
    metas = list(region.manifest.state.ssts)
    if len(metas) != LOG_SSTS or not all(m.fulltext for m in metas):
        raise AssertionError("index: the log SSTs lack their sidecars")
    return region, seconds


def plain_result(res) -> tuple:
    """A query result as picklable arrays: names, (values, validity)."""
    return (list(res.names), [(np.asarray(c.values),
                               np.asarray(c.valid_mask)) for c in res.cols])


def same_plain(a, b) -> bool:
    import types

    if a[0] != b[0] or len(a[1]) != len(b[1]):
        return False
    return all(same_column(types.SimpleNamespace(values=va, valid_mask=ma),
                           types.SimpleNamespace(values=vb, valid_mask=mb))
               for (va, ma), (vb, mb) in zip(a[1], b[1]))


def log_cpu_reference(seed):
    """18c's reference: the port on the CPU over the same access-log rows
    written anew, with the sidecars removed after the flushes so that
    nothing may be pruned: every count and the functions' rows."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.query import stats
    from greptimedb_tpu_torch.storage.sst import sidecar_path

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_logs_cpu_")
    inst = None
    try:
        inst = Standalone(root, device="cpu", warm_start=False)
        region, _ = write_logs(inst, seed)
        for m in region.manifest.state.ssts:
            region.store.delete(sidecar_path(m.path))
        answers = {}
        for name, (query, _) in LOG_QUERIES.items():
            with stats.collect() as st:
                answers[name] = plain_result(inst.sql(log_matches(query)))
            if st.counters.get("ssts_pruned_fulltext") or \
                    st.counters.get("row_groups_pruned_fulltext"):
                raise AssertionError("index: the sidecar-less scan pruned")
        answers["functions"] = plain_result(inst.sql(LOG_FUNCS.format(
            cut=LOG_T0 + LOG_FUNC_ROWS * LOG_STEP_MS)))
    finally:
        if inst is not None:
            inst.close()
        shutil.rmtree(root, ignore_errors=True)
    return answers, time.perf_counter() - t0


def fulltext_part(args, dev, iref, out):
    """18c: fulltext on an append-mode access log with a FULLTEXT message
    column, flushed into LOG_SSTS SSTs at the default row-group size,
    against the worker's CPU port over the same rows without sidecars."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.instance import Standalone
    from greptimedb_tpu_torch.query import stats
    from greptimedb_tpu_torch.storage.sst import sidecar_path

    root = tempfile.mkdtemp(prefix="chip_smoke_logs_")
    inst = None
    try:
        inst = Standalone(root, device=dev, warm_start=False)
        region, seconds = write_logs(inst, args.seed)
        sidecar_bytes = sum(len(region.store.read(sidecar_path(m.path)))
                            for m in region.manifest.state.ssts)
        answers, q_out = {}, {}
        for name, (query, want) in LOG_QUERIES.items():
            with stats.collect() as st:
                t = time.perf_counter()
                res = inst.sql(log_matches(query))
                wall = (time.perf_counter() - t) * 1e3
            answers[name] = plain_result(res)
            c = st.counters
            got = {k: int(c.get(k, 0)) for k in (
                "ssts_pruned_fulltext", "row_groups_pruned_fulltext",
                "row_groups_read", "row_groups_total")}
            for k, v in want.items():
                if got[k] != v:
                    raise AssertionError(f"index: {name} pruned {got}, "
                                         f"not {want}")
            if not want and (got["ssts_pruned_fulltext"]
                             or got["row_groups_pruned_fulltext"]):
                raise AssertionError(f"index: {name} pruned {got}")
            q_out[name] = {"query": query, "wall_ms": wall,
                           "count": int(res.cols[0].values[0]), **got}
        if q_out["present"]["count"] == 0 or q_out["absent"]["count"] != 0:
            raise AssertionError(f"index: log counts {q_out}")
        t = time.perf_counter()
        funcs = inst.sql(LOG_FUNCS.format(
            cut=LOG_T0 + LOG_FUNC_ROWS * LOG_STEP_MS))
        funcs_ms = (time.perf_counter() - t) * 1e3
        if funcs.num_rows != LOG_FUNC_ROWS:
            raise AssertionError(f"index: functions rows {funcs.num_rows}")
        answers["functions"] = plain_result(funcs)
    finally:
        if inst is not None:
            inst.close()
        shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    ref, ref_s = iref["logs"].get(timeout=900)
    seconds["cpu_reference_waited"] = time.perf_counter() - t
    seconds["cpu_reference_worker"] = ref_s
    for name, got in answers.items():
        if not same_plain(got, ref[name]):
            raise AssertionError(f"index: {name} differs from the CPU port "
                                 f"without sidecars")
    out["fulltext"] = {"rows": LOG_SSTS * LOG_ROWS, "ssts": LOG_SSTS,
                       "sidecar_bytes": sidecar_bytes, "seconds": seconds,
                       "queries": q_out, "functions_rows": LOG_FUNC_ROWS,
                       "functions_ms": funcs_ms}


def index_phase(args, dev, prom_out, iref):
    """Phase 18 (see the module docstring); `iref` is the reference
    worker's pending answers (start_index_reference). Returns every
    kernel's launches over the phase's main path."""
    from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.parallel.kernels import segmented_scan as ss
    from greptimedb_tpu_torch.parallel.kernels import topk_merge as tm

    t_phase = time.perf_counter()
    out = {}
    # every kernel wrapper's count (the PromQL programs launch K2, the
    # ring topk and G here)
    mods = {"gather_planes": mg, **{f: rf for f in FOLD_KERNELS},
            **{k: tm for k in TOPK_KERNELS},
            **{k: gr for k in GROUPED_KERNELS}, "segmented_scan": ss}
    for n, m in mods.items():
        getattr(m, n).launches = 0
    t = time.perf_counter()
    plane_part(dev, prom_out, iref, out)
    out["plane"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    index_probe_part(dev, iref, out)
    out["probe"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    fulltext_part(args, dev, iref, out)
    out["fulltext"]["part_seconds"] = time.perf_counter() - t
    launches = {n: getattr(m, n).launches for n, m in mods.items()
                if getattr(m, n).launches}
    emit({"phase": "index", **out, "launches": launches,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def walls_one(fn) -> float:
    """One warm host wall (ms) of `fn`, synchronised with the card."""
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


# phases whose inputs another phase makes: a selected phase brings these
PHASE_NEEDS = {3: {2}, 4: {2}, 5: {2}, 8: {2, 6}, 9: {2, 6}, 10: {7},
               11: {2}, 15: {14}, 16: {14}, 17: {14}, 18: {7}}
ALL_PHASES = tuple(range(1, 19))


def selected_phases(text: str | None) -> set:
    """The phases to run: every phase by default, else the listed ones,
    the phases whose inputs they take, and phase 1 (the build)."""
    if not text:
        return set(ALL_PHASES)
    want = {1}
    todo = [int(p) for p in text.split(",") if p.strip()]
    while todo:
        p = todo.pop()
        if p not in ALL_PHASES:
            raise SystemExit(f"chip_smoke: no phase {p} (phases "
                             f"{ALL_PHASES[0]}..{ALL_PHASES[-1]})")
        if p not in want:
            want.add(p)
            todo.extend(PHASE_NEEDS.get(p, ()))
    return want


def slice_phases(args, dev, P, want):
    """Phases 2 to 5 (see the module docstring). Returns the kernel rows
    of phase 4 (none when it did not run) and what later phases take from
    the slice: its table, engine, answers and shape."""
    from greptimedb_tpu_torch.catalog.table import Table
    from greptimedb_tpu_torch.parallel.kernels import merge_gather as mg
    from greptimedb_tpu_torch.parallel.kernels import ring_fold as rf
    from greptimedb_tpu_torch.query.executor import QueryEngine

    # ---- 2. the slice ------------------------------------------------
    rng = np.random.default_rng(args.seed)
    hosts = np.array([f"host_{i}" for i in range(args.hosts)])
    region_of = np.array(AWS_REGIONS)[rng.integers(0, len(AWS_REGIONS),
                                                    args.hosts)]
    table = Table("cpu", ts_name="ts", tag_names=["hostname", "region"],
                  fields=FIELDS)
    q1, q2 = make_plans(P)
    mg.gather_planes.launches = 0
    rf.blocked_fold_sum.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases = {}

    t = time.perf_counter()
    written = ingest(table, rng, hosts, region_of, args.hours)
    phases["ingest"] = time.perf_counter() - t
    rows0 = window_rows(table, 0)       # K1's inputs for phase 4

    t = time.perf_counter()
    merged = table.compact(device=dev, verify=True, kernels="on")
    torch.cuda.synchronize()
    phases["compact"] = time.perf_counter() - t
    paths = table.region.merge_paths
    if merged != args.hours or set(paths) != {"fused"}:
        raise AssertionError(f"compaction paths {paths}")

    eng = QueryEngine(device=dev)
    t = time.perf_counter()
    r1 = eng.execute(q1, table)
    torch.cuda.synchronize()
    phases["q1_cold_with_grid_build"] = time.perf_counter() - t
    t = time.perf_counter()
    r2 = eng.execute(q2, table)
    torch.cuda.synchronize()
    phases["q2_cold_with_state_growth"] = time.perf_counter() - t
    warm = {}
    for name, plan in (("q1", q1), ("q2", q2)):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            eng.execute(plan, table)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        warm[name] = float(np.median(times))
    phases["q1_warm_median"] = warm["q1"]
    phases["q2_warm_median"] = warm["q2"]
    launches = {"gather_planes": mg.gather_planes.launches,
                "blocked_fold_sum": rf.blocked_fold_sum.launches}
    grid_peak = torch.cuda.max_memory_allocated()
    entry = next(iter(eng.range_cache._entries.values()))
    emit({"phase": "slice", "seconds": phases, "rows_written": written,
          "rows_after_compaction": int(table.row_count()),
          "merges": merged, "merge_paths": sorted(set(paths)),
          "grid": {"series": entry.num_series, "cells": entry.nb,
                   "device_bytes": entry.bytes()},
          "max_memory_allocated": grid_peak, "launches": launches})
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    slice_out = {"table": table, "engine": eng, "hosts": args.hosts,
                 "hours": args.hours, "regions": len(set(region_of)),
                 "q1": r1, "q2": r2}

    # ---- 3. check ----------------------------------------------------
    if 3 in want:
        t = time.perf_counter()
        n_steps1 = args.hours
        if r1.num_rows != args.hosts * n_steps1:
            raise AssertionError(f"Q1 rows {r1.num_rows}")
        for c in r1.cols[2:]:
            if c.validity is not None or not np.isfinite(c.values).all():
                raise AssertionError("Q1 has missing or non-finite cells")
        if r2.num_rows != len(set(region_of)) * (args.hours + 1):
            raise AssertionError(f"Q2 rows {r2.num_rows}")
        cpu = QueryEngine(device="cpu")
        c1 = cpu.execute(q1, table)
        c2 = cpu.execute(q2, table)
        exact = {"count", "min", "max", "first_value", "last_value"}
        q1_err = compare_results("Q1", r1, c1, exact, w=HOUR_MS // STEP_MS)
        q2_err = compare_results("Q2", r2, c2, exact | {
            "sum", "mean", "stddev_samp"}, w=2 * HOUR_MS // STEP_MS)
        q1_np = check_q1_against_numpy(table, r1, hosts)
        emit({"phase": "check", "seconds": time.perf_counter() - t,
              "q1_rows": r1.num_rows, "q2_rows": r2.num_rows,
              "q1_max_abs_diff_vs_cpu": q1_err,
              "q2_max_abs_diff_vs_cpu": q2_err,
              "q1_max_rel_diff_vs_numpy": q1_np})

    # ---- 4. kernels --------------------------------------------------
    kernels = []
    add_ns = add_chain_ns(dev)
    if 4 in want:
        t = time.perf_counter()
        planes, src = k1_inputs(rows0, dev)
        memo = next(m for m in entry.query_memo.values() if m["fold"])
        kernels = kernel_checks(dev, planes, src, entry, memo, launches,
                                add_ns)
        emit({"phase": "kernels", "seconds": time.perf_counter() - t,
              "dependent_add_ns": add_ns})

    # ---- 5. profile: device busy time of one warm query each and of
    # one window's merge (no verify), under torch.profiler ------------
    if 5 in want:
        from greptimedb_tpu_torch.storage.device_merge import merge_rows

        t = time.perf_counter()
        profs = {"q1_warm": profiled(lambda: eng.execute(q1, table)),
                 "q2_warm": profiled(lambda: eng.execute(q2, table))}
        merge_prof = profs["merge_one_window"] = profiled(
            lambda: merge_rows(rows0, drop_deletes=True, device=dev,
                               kernels="on"))
        emit({"phase": "profile", **profs,
              "seconds": time.perf_counter() - t})
        if kernels:
            # K1's device time in the profiled merge of window 0
            kernels[0]["device_ms_per_launch_merge"] = device_ms_per_launch(
                merge_prof, lambda k: k.startswith("gather_planes"))
    return kernels, slice_out, add_ns


def run(args) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from greptimedb_tpu_torch.parallel.kernels import build
    from greptimedb_tpu_torch.query import planner as P
    from greptimedb_tpu_torch.query import sessions

    dev = _device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # query sessions off: every warm call of phases 1 to 16 runs its
    # program, as before sessions existed; phase 17 and phase 7's
    # repeated poll turn them on
    sessions.configure({"enable": False})
    want = selected_phases(args.phases)
    t_script = time.perf_counter()
    try:
        return run_phases(args, dev, P, build, want, t_script)
    finally:
        stop_window_reference(clean=False)
        stop_index_reference(clean=False)


_WREF_POOL = []


def stop_window_reference(clean: bool = True):
    """Stop the reference worker of phases 15 to 17, if one started:
    closed (its data root removed) after a run, terminated after a
    failure."""
    import shutil

    while _WREF_POOL:
        pool, root = _WREF_POOL.pop()
        if clean:
            pool.apply(wref_close)
            pool.close()
        else:
            pool.terminate()
        pool.join()
        shutil.rmtree(root, ignore_errors=True)


def run_phases(args, dev, P, build, want, t_script) -> int:

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "phases": sorted(want)})
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                emit({"ptxas": name, "line": line.strip()})
    smi = nvidia_smi_line()
    print(smi, flush=True)

    # ---- 2 to 5. the slice, its check, K1/K2 and the profile ----------
    kernels, slice_out, add_ns = [], None, None
    if 2 in want:
        kernels, slice_out, add_ns = slice_phases(args, dev, P, want)
    # ---- 6. mesh -----------------------------------------------------
    mesh_out = None
    if 6 in want:
        mesh_out = mesh_phase(args, dev, P)
        kernels += mesh_out["rows"]
    # ---- 7. promql ---------------------------------------------------
    prom_out = iref = None
    if 7 in want:
        prom_rows, prom_out = promql_phase(args, dev)
        kernels += prom_rows
    if 18 in want:
        # phase 18's CPU references build meanwhile, after phase 7's
        # timings
        iref = start_index_reference(args)
    # ---- 8. sql ------------------------------------------------------
    sql_launches, hop_launches, sql_per_launch = {}, {}, {}
    q2_warm = {"hops": {}, "fused": {}}
    if 8 in want:
        sql_launches, hop_launches, sql_per_launch, q2_warm = sql_phase(
            args, dev, slice_out, mesh_out)
    # ---- 9. rows -----------------------------------------------------
    rows_launches, rows_warm = {}, {"hops": {}, "fused": {}}
    if 9 in want:
        grouped_rows, rows_launches, rows_warm = rows_phase(
            args, dev, slice_out, mesh_out)
        kernels += grouped_rows
    # ---- 10. promql_rest ----------------------------------------------
    rest_launches, g_at_f, k2_at_c = {}, None, None
    if 10 in want:
        rest_launches, g_at_f, k2_at_c = promql_rest_phase(
            args, dev, prom_out, add_ns if add_ns else add_chain_ns(dev))
    # ---- 11. durable ---------------------------------------------------
    durable_launches = durable_phase(args, dev, slice_out, P) \
        if 11 in want else {}
    # ---- 12. server ----------------------------------------------------
    server_launches = server_phase(args, dev) if 12 in want else {}
    # ---- 13. flow ------------------------------------------------------
    flow_launches, flow_kern = {}, None
    if 13 in want:
        flow_launches, flow_kern = flow_phase(argparse.Namespace(
            **{**vars(args), "hours": args.flow_hours}), dev)
    # ---- 14. window ----------------------------------------------------
    window_out = wref = None
    if want & {15, 16, 17}:
        # phases 15 to 17's CPU reference builds its table meanwhile
        wref = start_window_reference(args)
    if 14 in want:
        window_rows_, window_out = window_phase(args, dev)
        kernels += window_rows_
    # ---- 15. relational ------------------------------------------------
    rel_launches = relational_phase(args, dev, window_out, wref) \
        if 15 in want else {}
    # ---- 16. session ---------------------------------------------------
    session_launches = session_phase(args, dev, window_out, wref) \
        if 16 in want else {}
    # ---- 17. poll ------------------------------------------------------
    poll_launches = poll_phase(args, dev, window_out, wref) \
        if 17 in want else {}
    stop_window_reference()
    # ---- 18. index -----------------------------------------------------
    index_launches = index_phase(args, dev, prom_out, iref) \
        if 18 in want else {}
    stop_index_reference()
    # every kernel's launches over the main-path runs of the phases that
    # ran; the hop ring's seed, continuation and combines run in phase 8
    # only, Gt in phase 9 only, G in phases 9, 10, 12, 13, 15 and 16, S in
    # 14 and 16, K1 in 2, 11, 12 and 14 (the compaction of the table 14,
    # 15, 16 and 17 read); phases 16 and 17 add K2's launches of their
    # RANGE queries
    extreme_row = next((r for r in kernels if r["name"] == "extreme"), {})
    floor = {k: v for k, v in extreme_row.items()
             if k.startswith("launch_floor")}
    for row in kernels:
        name = row["name"]
        row["launches"] += sql_launches.get(name, 0)
        if rest_launches.get(name):
            row["launches"] += rest_launches[name]
            row["launches_promql_rest"] = rest_launches[name]
        if name == "grouped_block_reduce" and g_at_f is not None:
            row["promql_f"] = g_at_f
        if name not in GROUPED_KERNELS and rows_launches.get(name):
            row["launches"] += rows_launches[name]
            row["launches_groupby"] = rows_launches[name]
            row["launches_per_warm_groupby"] = rows_warm[
                "hops" if name in GROUPBY_HOPS else "fused"].get(name, 0)
        if name == "blocked_fold_sum":
            if k2_at_c is not None:
                row["promql_c"] = k2_at_c
            if hop_launches:
                row["launches_hop_ring_sql"] = hop_launches[
                    "blocked_fold_sum"]
                row["device_ms_per_launch_hop_ring_q2"] = sql_per_launch[
                    "blocked_fold_sum"]
        elif name in sql_per_launch:
            row["device_ms_per_launch_sql_q2"] = sql_per_launch[name]
        if name in Q2_HOPS:
            row["launches_per_warm_sql_q2_hop_ring"] = q2_warm["hops"].get(
                name, 0)
        elif name in ONE_RING_KERNELS:
            row["launches_per_warm_sql_q2"] = q2_warm["fused"].get(name, 0)
        elif name in TOPK_KERNELS:
            row.update(floor)
        if durable_launches.get(name):
            row["launches"] += durable_launches[name]
            row["launches_durable"] = durable_launches[name]
        if server_launches.get(name):
            row["launches"] += server_launches[name]
            row["launches_server"] = server_launches[name]
        if flow_launches.get(name):
            row["launches"] += flow_launches[name]
            row["launches_flow"] = flow_launches[name]
        if rel_launches.get(name):
            row["launches"] += rel_launches[name]
            row["launches_relational"] = rel_launches[name]
        if session_launches.get(name):
            row["launches"] += session_launches[name]
            row["launches_session"] = session_launches[name]
        if poll_launches.get(name):
            row["launches"] += poll_launches[name]
            row["launches_poll"] = poll_launches[name]
        if index_launches.get(name):
            row["launches"] += index_launches[name]
            row["launches_index"] = index_launches[name]
        if name == "gather_planes" and window_out is not None:
            row["launches"] += window_out["k1_launches"]
            row["launches_window_table"] = window_out["k1_launches"]
        if name == "grouped_block_reduce" and flow_kern is not None:
            row["flow"] = flow_kern["flow"]
            row["float64_ext_form"] = flow_kern["float64_ext_form"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     flow_kern["max_abs_err"])
        if row["launches"] == 0:
            raise AssertionError(f"kernel {name} never launched")
    emit({"phases": sorted(want),
          "script_seconds": time.perf_counter() - t_script})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--mesh-hosts", type=int, default=8192)
    ap.add_argument("--mesh-hours", type=int, default=6)
    ap.add_argument("--prom-series", type=int, default=1_000_000)
    ap.add_argument("--hist-pods", type=int, default=12_500)
    ap.add_argument("--rest-warm", type=int, default=5,
                    help="warm runs of each phase-10 query (median)")
    ap.add_argument("--server-hours", type=int, default=1,
                    help="hours of TSBS devops phase 12 writes over HTTP")
    ap.add_argument("--flow-hours", type=int, default=2,
                    help="hours of TSBS devops phase 13 writes into flows")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all); "
                         "phase 1 and the phases a listed one takes its "
                         "inputs from run too")
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
