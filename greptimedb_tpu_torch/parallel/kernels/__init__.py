"""Hand-written CUDA kernels of the port, each beside its plain version.

- merge_gather.gather_planes (K1): the compaction merge-gather.
- ring_fold.blocked_fold_sum (K2): the blocked group fold, with the ring
  combines fold_cont, extreme and onehot_add, and the one-launch rings
  ring_fold_fused, ring_pext_fused and ring_psum_onehot_fused.
- topk_merge.merge_candidates: the topk ring's candidate merge, and
  topk_merge.ring_topk_merge_fused: the whole topk ring in one launch.
- grouped_reduce.grouped_block_reduce (G): the GROUP BY's fixed-order
  per-(block, group) sums and per-group extremes, and
  grouped_reduce.column_tree_sum (Gt): XLA:CPU's order of a column sum.
- segmented_scan.segmented_scan (S): the segmented scans of SQL window
  running frames, in jax.lax.associative_scan's combine tree.
"""
