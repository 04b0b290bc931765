"""``csr_block_pull``: tiled-CSR pull for high in-degree vertices (the
paper's block-per-vertex kernel).

Each high-degree vertex's in-edge list is padded to whole tiles of
``tile`` edges (host side, core/graph.py); `hi_rowmap[t]` names the high
slot tile t belongs to. The result is one in-edge sum per high slot.

On a CUDA tensor the wrapper launches the two-pass kernel in
`csrc/csr_block_pull.cu` (tile sums, then a fixed-order per-slot sum over
the slot→tile table of `core.pagerank.DeviceGraph`), its tile pass in the
instantiation `gather_plan.csr_plan` picks; on a CPU tensor it runs the
plain version,
`kernels.ref.csr_block_pull_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .gather_plan import aligned16, csr_plan
from .ref import csr_block_pull_ref
from ..sentinel import take_fill

__all__ = ["csr_block_pull", "csr_block_pull_plain"]

_SIG = {"csr_block_pull": [_build.P] * 4 + [_build.I] * 4 + [_build.P] * 2
        + [_build.I] + [_build.P] * 3}


def csr_block_pull_plain(c, hi_tiles, hi_tmask, hi_rowmap, n_rows, *,
                         tile_sel=None):
    """The plain PyTorch version. Dead `tile_sel` lanes (== t_cap) go to a
    sink slot and are dropped, as the kernel skips them."""
    if tile_sel is None:
        return csr_block_pull_ref(c, hi_tiles, hi_tmask, hi_rowmap, n_rows)
    tiles = take_fill(hi_tiles, tile_sel, 0)
    tmask = take_fill(hi_tmask, tile_sel, 0.0)
    rowmap = take_fill(hi_rowmap, tile_sel, n_rows)
    return csr_block_pull_ref(c, tiles, tmask, rowmap, n_rows + 1)[:n_rows]


def csr_block_pull(c: torch.Tensor, hi_tiles: torch.Tensor,
                   hi_tmask: torch.Tensor, hi_rowmap: torch.Tensor,
                   n_rows: int, *, tile_sel: Optional[torch.Tensor] = None,
                   slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """out[hi_rowmap[t]] += sum(c[hi_tiles[t]] * hi_tmask[t]) for each tile t.

    Returns per-high-slot sums, shape [n_rows]. With `tile_sel` (a
    compacted [k_t] active-tile list, sentinel == t_cap —
    core.frontier.ActiveFrontier) only the selected tiles are summed; only
    exact when the selection covers every live tile of the rows the caller
    reads. `slots` = (slot_tiles, slot_off), the slot→tile table
    (`DeviceGraph.hi_slot_tiles` / `hi_slot_off`), is required on CUDA.
    """
    if c.device.type == "cpu":
        return csr_block_pull_plain(c, hi_tiles, hi_tmask, hi_rowmap, n_rows,
                                    tile_sel=tile_sel)
    return _launch(c, hi_tiles, hi_tmask, hi_rowmap, n_rows, tile_sel, slots)


def _launch(c, tiles, tmask, rowmap, n_rows, tile_sel, slots):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"csr_block_pull: no kernel for device {dev}")
    if slots is None:
        raise ValueError("csr_block_pull: the slot->tile table `slots` is "
                         "required on CUDA")
    if tiles.dim() != 2 or n_rows <= 0:
        raise ValueError("csr_block_pull: bad tile table or row count")
    t_cap, tile = tiles.shape
    slot_tiles, slot_off = slots
    _build.check("csr_block_pull c", c, torch.float64, (c.shape[0],), dev)
    _build.check("csr_block_pull hi_tiles", tiles, torch.int32,
                 (t_cap, tile), dev)
    _build.check("csr_block_pull hi_tmask", tmask, torch.float32,
                 (t_cap, tile), dev)
    _build.check("csr_block_pull hi_rowmap", rowmap, torch.int32, (t_cap,),
                 dev)
    _build.check("csr_block_pull slot_tiles", slot_tiles, torch.int32,
                 (t_cap,), dev)
    _build.check("csr_block_pull slot_off", slot_off, torch.int32,
                 (n_rows + 1,), dev)
    if tile_sel is None:
        n_sel, sel_ptr = t_cap, None
        tsum = torch.empty(t_cap, dtype=torch.float64, device=dev)
    else:
        n_sel = tile_sel.shape[0]
        _build.check("csr_block_pull tile_sel", tile_sel, torch.int32,
                     (n_sel,), dev)
        sel_ptr = tile_sel.data_ptr()
        tsum = torch.zeros(t_cap, dtype=torch.float64, device=dev)
    out = torch.empty(n_rows, dtype=torch.float64, device=dev)
    plan = csr_plan(tile, aligned16(tiles.data_ptr(), tmask.data_ptr()))
    lib = _build.load("csr_block_pull", _SIG)
    err = lib.csr_block_pull(
        c.data_ptr(), tiles.data_ptr(), tmask.data_ptr(), sel_ptr, n_sel,
        t_cap, tile, int(plan.width != 0), slot_tiles.data_ptr(),
        slot_off.data_ptr(), n_rows, tsum.data_ptr(), out.data_ptr(),
        _build.stream_ptr(dev))
    _build.launch_error("csr_block_pull", err)
    csr_block_pull.launches += 1
    return out


csr_block_pull.launches = 0
