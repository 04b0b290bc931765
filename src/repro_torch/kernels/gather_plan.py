"""Which instantiation of the gather body (`csrc/ell_gather.cuh`) runs a
slot table: the one place that decides it.

`PLANS` lists the instantiations of the ELL kernels (`ell_pull`,
`fused_ell_update`); a bucket's plan goes to the C entries as its index in
`PLANS` (its kind). `_build` writes `header()` into the generated header
`ell_plans.h` that the CUDA sources include, so the kernels instantiate
exactly the plans this module can pick. `csr_plan` picks between the two
instantiations of `csr_block_pull`'s tile pass.

A template width runs its 16-byte loads only on a table whose idx and mask
start on a 16-byte boundary (each row then does too); any other table of
that width takes the generic loop over the runtime width. Nothing here
imports torch, so the choice is testable without a card.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["GatherPlan", "ELL_TEMPLATES", "CSR_TILE", "PLANS", "lanes_for",
           "ell_plan", "ell_kind", "csr_plan", "aligned16", "header"]


class GatherPlan(NamedTuple):
    """`width`: the template width (0: the generic loop over the runtime
    width); `lanes`: threads per row; `vec`: 16-byte loads of idx and
    mask."""
    width: int
    lanes: int
    vec: bool


# template widths -> lanes per row: each lane owns 4 slots of its row, one
# 16-byte word of idx and one of mask (the whole row below width 4, with
# 4-byte loads)
ELL_TEMPLATES = {1: 1, 2: 1, 4: 1, 8: 2, 16: 4, 32: 8, 64: 16}
# the main path's tile, csr_block_pull's template (a warp of 32 per tile,
# 8 slots a lane)
CSR_TILE = 256
_WARP = 32

PLANS = (tuple(GatherPlan(w, n, w % 4 == 0) for w, n in ELL_TEMPLATES.items())
         + tuple(GatherPlan(0, n, False) for n in (1, 2, 4, 8, 16, 32)))


def lanes_for(width: int) -> int:
    """Threads per row of the generic loop: one for the narrowest rows (the
    paper's thread-per-vertex kernel), else a sub-warp of the largest
    power of two up to min(width, 32), which divides the warp."""
    if width <= 2:
        return 1
    lanes = 1
    while lanes * 2 <= min(width, _WARP):
        lanes *= 2
    return lanes


def ell_plan(width: int, aligned: bool) -> GatherPlan:
    """The plan of a [rows, width] table whose idx and mask start on a
    16-byte boundary iff `aligned`: the template of its width when there
    is one and it can run the table (16-byte loads need `aligned`), else
    the generic loop at `lanes_for(width)` lanes."""
    lanes = ELL_TEMPLATES.get(width)
    if lanes is not None and (width % 4 != 0 or aligned):
        return GatherPlan(width, lanes, width % 4 == 0)
    return GatherPlan(0, lanes_for(width), False)


def ell_kind(width: int, aligned: bool) -> int:
    """`ell_plan`'s plan as the C entries take it: its index in PLANS."""
    return PLANS.index(ell_plan(width, aligned))


def csr_plan(tile: int, aligned: bool) -> GatherPlan:
    """The plan of csr_block_pull's tile pass: the template at CSR_TILE on
    aligned tables, the generic loop (a warp per tile) otherwise."""
    if tile == CSR_TILE and aligned:
        return GatherPlan(CSR_TILE, _WARP, True)
    return GatherPlan(0, _WARP, False)


def aligned16(*ptrs: int) -> bool:
    """Whether every address starts on a 16-byte boundary."""
    return all(p % 16 == 0 for p in ptrs)


def header() -> str:
    """The text of the generated `ell_plans.h`: ELL_PLANS(X) calls
    X(kind, W, LANES, VEC) for each plan, and kCsrTile."""
    rows = " \\\n".join(f"  X({k}, {p.width}, {p.lanes}, "
                        f"{'true' if p.vec else 'false'})"
                        for k, p in enumerate(PLANS))
    return ("// Generated from src/repro_torch/kernels/gather_plan.py by "
            "kernels/_build.py.\n#pragma once\n\n"
            f"#define ELL_PLANS(X) \\\n{rows}\n\n"
            f"constexpr int kCsrTile = {CSR_TILE};\n")
