"""Automatic tiling: expression DAG -> tiled task graph (CMM §3.2, Listing 1).

A single tile size ``t`` (or ``(tm, tn)`` tuple) is applied to every matrix in
the expression, exactly like the paper (edge tiles are ragged via ``min``
bounds as in Listing 1).  The expression DAG is expanded node-by-node into
per-tile tasks while preserving the task dependencies; tiled matmul
introduces the ``calloc`` + ``addmul``-chain structure of Fig. 2.  The
expansion is the JAX reference's (``repro.core.tiling``), task for task.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

from .graph import TaskGraph, TaskKind, TileRef, matmul_epilogue, matmul_flags
from .lazy import ClusteredMatrix, Op, topo_order_many


def cld(a: int, b: int) -> int:
    """Ceiling division (Julia's ``cld`` used in Listing 1)."""
    return -(-a // b)


def tile_slices(dim: int, tile: int) -> List[Tuple[int, int]]:
    """Listing 1 row/col bounds: [(start, end)] with ragged final tile."""
    n = cld(dim, tile)
    return [(tile * i, min(tile * (i + 1), dim)) for i in range(n)]


def grid_of(shape: Tuple[int, int], tile: Tuple[int, int]) -> Tuple[int, int]:
    return (cld(shape[0], tile[0]), cld(shape[1], tile[1]))


def tile_shape(shape: Tuple[int, int], tile: Tuple[int, int],
               i: int, j: int) -> Tuple[int, int]:
    rs = tile_slices(shape[0], tile[0])[i]
    cs = tile_slices(shape[1], tile[1])[j]
    return (rs[1] - rs[0], cs[1] - cs[0])


def normalize_tile(tile) -> Tuple[int, int]:
    """``t`` or ``(t, t)`` -> ``(t, t)``.  Only square tiles are taken:
    transposes are always folded into matmul flags, and transposed tile
    indexing is ill-defined for a non-square tile on a ragged grid."""
    if isinstance(tile, int):
        return (tile, tile)
    tm, tn = (int(x) for x in tile)
    if tm != tn:
        raise ValueError(f"non-square tile {tile!r}: only square tiles "
                         "are supported")
    return (tm, tn)


@dataclass
class ResultSet:
    """One root's output tiles in the (possibly multi-root) tiled program,
    in (i, j) grid order."""

    uid: int                              # root expr-node uid
    shape: Tuple[int, int]
    tiles: List[TileRef] = field(default_factory=list)


class TiledProgram:
    """Result of tiling: the task graph plus tile bookkeeping for execution."""

    def __init__(self, graph: TaskGraph, tile: Tuple[int, int],
                 leaf_nodes: Dict[int, ClusteredMatrix],
                 dtypes: Dict[int, torch.dtype]):
        self.graph = graph
        self.tile = tile
        #: expr-node uid -> leaf ClusteredMatrix (for FILL materialisation)
        self.leaf_nodes = leaf_nodes
        #: expr-node uid -> torch dtype (CALLOC allocates in the expression
        #: dtype, not float64)
        self.dtypes = dtypes
        #: canonical leaf-uid order (plan-cache leaf rebinding contract)
        self.leaf_order = list(leaf_nodes)
        #: one ResultSet per root, in caller order
        self.result_sets: List[ResultSet] = []

    def rebound(self, new_leaves) -> "TiledProgram":
        """A shallow copy with FILL leaves rebound to ``new_leaves`` (same
        canonical order) — how a plan-cache hit serves a structurally equal
        DAG holding different data."""
        if len(new_leaves) != len(self.leaf_order):
            raise ValueError("leaf count mismatch on plan-cache rebind")
        leaf_nodes = dict(zip(self.leaf_order, new_leaves))
        p = TiledProgram(self.graph, self.tile, leaf_nodes, self.dtypes)
        p.leaf_order = list(self.leaf_order)
        p.result_sets = self.result_sets
        return p


def tile_expression(root: ClusteredMatrix, tile) -> TiledProgram:
    """Expand one expression DAG into a tiled TaskGraph (single-root
    wrapper over :func:`tile_expression_many`)."""
    return tile_expression_many((root,), tile)


def tile_expression_many(roots: Sequence[ClusteredMatrix],
                         tile) -> TiledProgram:
    """Expand one or more expression DAGs into ONE tiled TaskGraph.

    Per node we keep ``producer[(i, j)]`` — the task id that last wrote tile
    ``(i, j)`` of that node's output — so consumers depend on exactly the
    right task (for matmul that is the *last* addmul of the k-chain).
    Every root's tiles are gathered to the master by TAKECOPY tasks.
    """
    from .fusion import fused_flops

    t = normalize_tile(tile)
    g = TaskGraph()
    # node uid -> {(i,j): (TileRef, producer_tid)}
    tiles: Dict[int, Dict[Tuple[int, int], Tuple[TileRef, int]]] = {}
    leaf_nodes: Dict[int, ClusteredMatrix] = {}
    dtypes: Dict[int, torch.dtype] = {}

    def ref(node: ClusteredMatrix, i: int, j: int) -> TileRef:
        return TileRef(node.uid, i, j, tile_shape(node.shape, t, i, j))

    for node in topo_order_many(roots):
        gm, gn = grid_of(node.shape, t)
        entry: Dict[Tuple[int, int], Tuple[TileRef, int]] = {}
        dtypes[node.uid] = node.dtype

        if node.op in (Op.INPUT, Op.RANDOM, Op.ZEROS, Op.EYE):
            leaf_nodes[node.uid] = node
            for i in range(gm):
                for j in range(gn):
                    r = ref(node, i, j)
                    # fill = data materialisation for an input tile; the
                    # scheduler delays it until just before first use (§3.3)
                    task = g.add(TaskKind.FILL, (), r, payload=node.uid)
                    entry[(i, j)] = (r, task.tid)

        elif node.op is Op.MATMUL:
            a, b = node.parents[:2]
            extras = node.parents[2:]      # epilogue operands
            epi = matmul_epilogue(node.payload)
            ga = tiles[a.uid]
            gb = tiles[b.uid]
            # transposed-operand flags folded in by the fusion optimizer:
            # operand tiles are indexed through the transpose instead of a
            # materialised TRANSPOSE pass (needs a square tile)
            ta, tb = matmul_flags(node.payload)
            if (ta or tb) and t[0] != t[1]:
                raise ValueError("transposed matmul needs a square tile")
            # the inner dimension is tiled by tn on A but by tm on B; a
            # non-square tile misaligns the k-chains unless the inner dim
            # fits in a single tile both ways
            n_inner = a.shape[0] if ta else a.shape[1]
            if t[0] != t[1] and max(cld(n_inner, t[0]),
                                    cld(n_inner, t[1])) > 1:
                raise ValueError(
                    f"MATMUL inner dim {n_inner} needs a square tile, "
                    f"got {t}; use an int tile size")
            kt = grid_of(a.shape, t)[0 if ta else 1]  # inner tile count
            flags = (ta, tb) if ta or tb else None
            if epi is not None:
                # the k-chain accumulates in the *matmul* dtype; the
                # epilogue's own output dtype emerges when the last chain
                # task rebinds the tile
                dtypes[node.uid] = torch.promote_types(a.dtype, b.dtype)
            for i in range(gm):
                for j in range(gn):
                    r = ref(node, i, j)
                    calloc = g.add(TaskKind.CALLOC, (), r, payload=node.uid)
                    prev = calloc.tid
                    for k in range(kt):
                        ra, pa = ga[(k, i) if ta else (i, k)]
                        rb, pb = gb[(j, k) if tb else (k, j)]
                        m_ = ra.shape[1] if ta else ra.shape[0]
                        n_ = ra.shape[0] if ta else ra.shape[1]
                        k_ = rb.shape[0] if tb else rb.shape[1]
                        ins = (ra, rb)
                        deps = (prev, pa, pb)
                        payload = flags
                        flops = 2 * m_ * n_ * k_
                        if epi is not None and k == kt - 1:
                            # the LAST chain task applies the epilogue to
                            # the accumulated C tile in the same pass
                            eins = [tiles[e.uid][(i, j)] for e in extras]
                            ins += tuple(er for er, _ in eins)
                            deps += tuple(ep for _, ep in eins)
                            payload = node.payload
                            flops += fused_flops(epi, *r.shape)
                        task = g.add(TaskKind.ADDMUL, ins, r,
                                     payload=payload, flops=flops,
                                     deps=deps)
                        prev = task.tid
                    entry[(i, j)] = (r, prev)

        elif node.op in (Op.ADD, Op.SUB, Op.EWMUL):
            kind = {Op.ADD: TaskKind.ADD, Op.SUB: TaskKind.SUB,
                    Op.EWMUL: TaskKind.EWMUL}[node.op]
            a, b = node.parents
            for i in range(gm):
                for j in range(gn):
                    ra, pa = tiles[a.uid][(i, j)]
                    rb, pb = tiles[b.uid][(i, j)]
                    r = ref(node, i, j)
                    m_, n_ = r.shape
                    task = g.add(kind, (ra, rb), r, flops=m_ * n_,
                                 deps=(pa, pb))
                    entry[(i, j)] = (r, task.tid)

        elif node.op is Op.SCALE:
            (kindstr, s) = node.payload
            a = node.parents[0]
            for i in range(gm):
                for j in range(gn):
                    ra, pa = tiles[a.uid][(i, j)]
                    r = ref(node, i, j)
                    task = g.add(TaskKind.SCALE, (ra,), r,
                                 payload=(kindstr, s),
                                 flops=r.shape[0] * r.shape[1], deps=(pa,))
                    entry[(i, j)] = (r, task.tid)

        elif node.op is Op.EWISE:
            a = node.parents[0]
            for i in range(gm):
                for j in range(gn):
                    ra, pa = tiles[a.uid][(i, j)]
                    r = ref(node, i, j)
                    task = g.add(TaskKind.EWISE, (ra,), r, payload=node.payload,
                                 flops=4 * r.shape[0] * r.shape[1], deps=(pa,))
                    entry[(i, j)] = (r, task.tid)

        elif node.op is Op.FUSED:
            # one task per tile for the whole elementwise region: inputs are
            # the (i, j) tiles of every external parent
            for i in range(gm):
                for j in range(gn):
                    ins, deps = [], []
                    for p in node.parents:
                        rp, pp = tiles[p.uid][(i, j)]
                        ins.append(rp)
                        deps.append(pp)
                    r = ref(node, i, j)
                    task = g.add(TaskKind.FUSED, ins, r, payload=node.payload,
                                 flops=fused_flops(node.payload, *r.shape),
                                 deps=deps)
                    entry[(i, j)] = (r, task.tid)

        elif node.op is Op.TRANSPOSE:
            # tile (i, j) of the transpose is the transpose of parent tile
            # (j, i) — which only lines up when the tile is square
            if t[0] != t[1]:
                raise ValueError(
                    f"TRANSPOSE needs a square tile, got {t}; "
                    f"use an int tile size")
            a = node.parents[0]
            for i in range(gm):
                for j in range(gn):
                    ra, pa = tiles[a.uid][(j, i)]
                    r = ref(node, i, j)
                    task = g.add(TaskKind.TRANSPOSE, (ra,), r,
                                 flops=r.shape[0] * r.shape[1], deps=(pa,))
                    entry[(i, j)] = (r, task.tid)

        else:  # pragma: no cover
            raise ValueError(node.op)

        tiles[node.uid] = entry

    # takecopy: gather every result tile to the master node.  Each takecopy
    # depends only on its own producer chain (§3.3 optimisation).
    prog = TiledProgram(g, t, leaf_nodes, dtypes)
    for root in roots:
        gm, gn = grid_of(root.shape, t)
        rs = ResultSet(root.uid, root.shape)
        for i in range(gm):
            for j in range(gn):
                r, p = tiles[root.uid][(i, j)]
                rs.tiles.append(r)
                g.add(TaskKind.TAKECOPY, (r,), r, deps=(p,))
        prog.result_sets.append(rs)
    return prog


def assemble(tile_values: Dict[TileRef, torch.Tensor],
             shape: Tuple[int, int], tile: Tuple[int, int],
             tensor_uid: int) -> torch.Tensor:
    """Reassemble a full matrix from its tile values (inverse of tiling)."""
    rows = tile_slices(shape[0], tile[0])
    cols = tile_slices(shape[1], tile[1])
    first = next(iter(tile_values.values()))
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    for i, (r0, r1) in enumerate(rows):
        for j, (c0, c1) in enumerate(cols):
            key = TileRef(tensor_uid, i, j, (r1 - r0, c1 - c0))
            out[r0:r1, c0:c1] = tile_values[key]
    return out
