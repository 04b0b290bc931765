"""Core library: Static + DF/DF-P PageRank on PyTorch tensors."""
from .graph import (Graph, HybridLayout, HybridRows, BatchUpdate, EllBucket,
                    build_graph, build_hybrid, build_hybrid_rows,
                    bucket_band_counts, choose_bucket_widths,
                    layout_slot_stats, apply_batch, random_graph,
                    powerlaw_graph, random_batch, temporal_stream, edge_keys,
                    keys_to_edges, next_pow2, ragged_positions, hybrid_caps,
                    graph_from_sorted_keys)
from .partition import partition_by_degree
from .rank_step import rank_step, rank_value, relative_change, teleport
from .pagerank import (DeviceGraph, EllBlock, PRParams, resolve_device,
                       to_device, device_graph, as_device_graph, init_ranks,
                       pull_sum, pull_max, update_ranks, static_pagerank)
from .frontier import (initial_affected, expand_affected, reach_affected,
                       ActiveFrontier, FrontierCaps, active_frontier,
                       active_pull_sum, caps_for, caps_for_parts, merge_caps,
                       plan_capacity, push_expand, expand_frontier,
                       stream_compact, update_ranks_active)
from .dynamic import (DeviceBatch, batch_to_device, nd_pagerank, dt_pagerank,
                      df_pagerank, dfp_pagerank)
from .compact import (forward_device_graph, dfp_pagerank_compact,
                      df_pagerank_compact)
from .reference import reference_pagerank, numpy_pagerank, l1_error

__all__ = [
    "Graph", "HybridLayout", "HybridRows", "BatchUpdate", "EllBucket",
    "build_graph", "build_hybrid", "build_hybrid_rows",
    "bucket_band_counts", "choose_bucket_widths", "layout_slot_stats",
    "apply_batch", "random_graph", "powerlaw_graph", "random_batch",
    "temporal_stream", "edge_keys", "keys_to_edges", "next_pow2",
    "ragged_positions", "hybrid_caps", "graph_from_sorted_keys",
    "partition_by_degree",
    "rank_step", "rank_value", "relative_change", "teleport",
    "DeviceGraph", "EllBlock", "PRParams", "resolve_device", "to_device",
    "device_graph", "as_device_graph", "init_ranks", "pull_sum", "pull_max",
    "update_ranks", "static_pagerank",
    "initial_affected", "expand_affected", "reach_affected",
    "ActiveFrontier", "FrontierCaps", "active_frontier", "active_pull_sum",
    "caps_for", "caps_for_parts", "merge_caps", "plan_capacity",
    "push_expand", "expand_frontier", "stream_compact",
    "update_ranks_active",
    "DeviceBatch", "batch_to_device", "nd_pagerank", "dt_pagerank",
    "df_pagerank", "dfp_pagerank",
    "forward_device_graph", "dfp_pagerank_compact", "df_pagerank_compact",
    "reference_pagerank", "numpy_pagerank", "l1_error",
]
