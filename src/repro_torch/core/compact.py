"""The forward (out-edge) layout that push-style frontier expansion walks.

The frontier-compacted engines of the JAX package's `repro.core.compact`
come with a later slice of the port; `core.dynamic` already runs the
compacted DF / DF-P path through `frontier_caps=`.
"""
from __future__ import annotations

from .graph import Graph, build_hybrid
from .pagerank import DeviceGraph, resolve_device, to_device

__all__ = ["forward_device_graph"]


def forward_device_graph(g: Graph, d_p: int = 64, tile: int = 1024,
                         device=None, **caps) -> DeviceGraph:
    """Out-edge hybrid layout (the paper's 'Partition G' by out-degree):
    rows of the ELL are each vertex's OUT-neighbors."""
    dev = resolve_device(device)      # raise before the host build
    return to_device(build_hybrid(g.transpose(), d_p=d_p, tile=tile, **caps),
                     device=dev)
