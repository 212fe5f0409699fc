"""The collective census of a step, and the graph axis's gather contract.

Counterpart of the JAX package's `parallel/audit.py`, which parses the
compiled HLO for all-gathers.  Here every collective goes through
`parallel.collectives`, which records each call in the mesh's open census:
kind (all_reduce, all_gather, halo, broadcast), call site, axis, elements
and bytes.

The contract (`assert_no_large_gather`): band-level activations are split
over the graph axis and move between ranks only as halo tiles.  An
all-gather at least as large as the smallest band activation is allowed
only at a graph-split level's boundary (the sites in TRANSITION_SITES), at
most `allow_max` of them (`boundary_gathers`): in the forward one where
each split level is left (a level transition, or the final rows), in the
backward one where each was entered (`scatter_rows`' cotangent).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

from .collectives import backward_site

__all__ = ["Census", "census", "assert_no_large_gather", "band_threshold",
           "boundary_gathers", "LEVEL_ENTRY", "LEVEL_TRANSITION", "FINAL_ROWS",
           "TRANSITION_SITES"]

# the sites of models.meshnet's collectives at a graph-split level's
# boundary: the scatter into it, the gather out of it to the next level, the
# gather of the finest level's rows
LEVEL_ENTRY = "level entry"
LEVEL_TRANSITION = "level transition"
FINAL_ROWS = "final rows"
TRANSITION_SITES = (LEVEL_TRANSITION, FINAL_ROWS, backward_site(LEVEL_ENTRY))


class Census:
    """Every collective call since the census opened."""

    def __init__(self):
        self.records: List[Tuple[str, str, str, int, int]] = []

    def add(self, kind: str, site: str, axis: str, elems: int, nbytes: int) -> None:
        self.records.append((kind, site, axis, elems, nbytes))

    def summary(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{"by_kind": {kind: {"count", "bytes"}}, "by_site": {"kind @ site
        [axis]": {"count", "bytes"}}}."""
        by_kind: Dict = defaultdict(lambda: {"count": 0, "bytes": 0})
        by_site: Dict = defaultdict(lambda: {"count": 0, "bytes": 0})
        for kind, site, axis, _, nbytes in self.records:
            for d in (by_kind[kind], by_site[f"{kind} @ {site} [{axis}]"]):
                d["count"] += 1
                d["bytes"] += nbytes
        return {"by_kind": dict(by_kind), "by_site": dict(by_site)}


@contextlib.contextmanager
def census(mesh) -> Iterator[Census]:
    """Record every collective on `mesh` inside the block."""
    c = Census()
    mesh.census = c
    try:
        yield c
    finally:
        mesh.census = None


def band_threshold(art, batch: int, min_feat: int) -> int:
    """Elements of the smallest band-level activation: the fewest rows of a
    graph-split level times the batch times the fewest channels."""
    rows = [op.num_vertices for op in art.mesh_ops if op.kind in ("band", "halo")]
    if not rows:
        raise ValueError("the artifact has no band level")
    return min(rows) * batch * min_feat


def boundary_gathers(art, backward: bool = True) -> int:
    """The band-sized gathers TRANSITION_SITES allow on this rank's sharded
    `art`: one out of each graph-split ("halo") level, and with `backward`
    one more into each."""
    split = sum(op.kind == "halo" for op in art.mesh_ops)
    return split * (2 if backward else 1)


def assert_no_large_gather(c: Census, threshold_elems: int, allow_max: int,
                           context: str = "") -> None:
    """Fail on an all-gather of `threshold_elems` or more elements outside
    TRANSITION_SITES, or on more than `allow_max` of them at those sites."""
    big, allowed = [], []
    for kind, site, axis, elems, _ in c.records:
        if kind != "all_gather" or elems < threshold_elems:
            continue
        (allowed if site in TRANSITION_SITES else big).append((elems, site, axis))
    if big:
        raise AssertionError(
            f"{context}: {len(big)} all-gather(s) of a band-sized activation "
            f"(>= {threshold_elems} elements) outside the level transitions: "
            f"{sorted(big)[-3:]}; band levels must move as halo tiles")
    if len(allowed) > allow_max:
        raise AssertionError(
            f"{context}: {len(allowed)} band-sized all-gathers at the level "
            f"transitions, more than the {allow_max} allowed: {sorted(allowed)[-5:]}")
