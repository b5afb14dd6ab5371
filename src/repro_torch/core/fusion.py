"""Expression-graph optimizer (CMM §3.1: "optimize matrix operations on the
fly" before tiling and scheduling).

The engine runs these rewrite passes over the lazy expression DAG *before*
``tile_expression``, so tiling / HEFT / simulation all see the reduced graph:

* **identity folding** — ``A + zeros``, ``A - zeros``, ``A @ eye``,
  ``eye @ A``, ``A * 1.0``, ``A / 1.0``, ``(A.T).T`` collapse to ``A``
  (only when the fold preserves the result dtype);
* **transpose folding** — a ``TRANSPOSE`` operand of a ``MATMUL`` becomes a
  transposed-operand flag ``(ta, tb)`` on the MATMUL node, so no transposed
  intermediate is ever materialised (BLAS consumes the transposed view
  directly);
* **CSE** — structurally identical subexpressions (same op, canonicalised
  parents and value-relevant payload) are merged, so a shared subexpression
  is computed once;
* **elementwise fusion** — maximal connected regions of
  EWISE/SCALE/ADD/SUB/EWMUL nodes whose interior nodes have a single
  consumer collapse into one FUSED node.  A FUSED node executes as *one*
  task per tile, eliminating every interior tile buffer of the chain.
  Multi-consumer nodes are never inlined (their value is needed elsewhere);
  they can still root their own region.
* **matmul-epilogue fusion** — an elementwise node or FUSED region whose
  only use of a single-consumer MATMUL is as a same-shaped operand is
  folded INTO that matmul as an **epilogue program** on its payload
  (``graph.epilogue_payload``).  The hot shape ``relu(A@B + C)`` then
  executes as the addmul k-chain alone: the last chain task applies the
  epilogue to the accumulated ``C`` tile in one pass — no FUSED task, no
  materialised matmul intermediate.  The epilogue reuses the FUSED
  tile-program encoding with input slot 0 = the accumulator and slots
  ``1..`` = the extra operands appended to the MATMUL's parents.

The FUSED payload is a small hashable tile program — a tuple of
instructions in topological order::

    ("in", k)                   # tile of the k-th parent
    ("ewise", fn, i)            # EWISE_FNS[fn](vals[i])
    ("scale", kind, s, i)       # apply_scale(kind, vals[i], s)
    ("add"|"sub"|"ewmul", i, j) # binary elementwise

The last instruction is the output.  ``eval_fused`` interprets it over
full tiles of torch tensors.  The passes are the JAX reference's
(``repro.core.fusion``), rewrite for rewrite, so both packages emit the same
programs and the same ``FusionReport``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from .graph import epilogue_payload, matmul_epilogue, matmul_flags
from .lazy import (ClusteredMatrix, EWISE_FNS, Op, apply_scale,
                   topo_order_many)

#: expression ops that are elementwise over same-shaped operands
ELEMENTWISE_OPS = {Op.ADD, Op.SUB, Op.EWMUL, Op.SCALE, Op.EWISE}

LEAF_OPS = {Op.INPUT, Op.RANDOM, Op.ZEROS, Op.EYE}


@dataclass
class FusionReport:
    """What the optimizer did — surfaced on the Plan for benchmarks/tests."""

    nodes_before: int = 0
    nodes_after: int = 0
    cse_merged: int = 0
    identities_folded: int = 0
    transposes_folded: int = 0
    fused_regions: int = 0
    fused_ops: int = 0          # elementwise nodes swallowed by FUSED regions
    epilogues_fused: int = 0    # FUSED/elementwise nodes folded into a MATMUL
    epilogue_ops: int = 0       # arithmetic instrs now running as epilogues

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


# ---------------------------------------------------------------------------
# pass 1: identity + transpose folding (single bottom-up rebuild)
# ---------------------------------------------------------------------------

def _is_zeros(n: ClusteredMatrix) -> bool:
    return n.op is Op.ZEROS


def _is_eye(n: ClusteredMatrix) -> bool:
    return n.op is Op.EYE


def fold_identities_many(roots: Sequence[ClusteredMatrix],
                         report: FusionReport) -> List[ClusteredMatrix]:
    """Algebraic identity folding + transpose-into-matmul flag folding over
    the union DAG of several roots (shared subexpressions are rewritten
    once)."""
    new: Dict[int, ClusteredMatrix] = {}

    def rewritten(node: ClusteredMatrix) -> ClusteredMatrix:
        return new[node.uid]

    for node in topo_order_many(roots):
        parents = tuple(rewritten(p) for p in node.parents)
        out: Optional[ClusteredMatrix] = None

        if node.op is Op.ADD:
            a, b = parents
            if _is_zeros(b) and a.dtype == node.dtype:
                out = a
            elif _is_zeros(a) and b.dtype == node.dtype:
                out = b
        elif node.op is Op.SUB:
            a, b = parents
            if _is_zeros(b) and a.dtype == node.dtype:
                out = a
        elif node.op is Op.SCALE:
            kind, s = node.payload
            a = parents[0]
            if a.dtype == node.dtype and (
                    (kind in ("scale", "mul", "ewmul", "div") and s == 1.0)
                    or (kind in ("add", "sub") and s == 0.0)):
                out = a
        elif node.op is Op.TRANSPOSE:
            a = parents[0]
            if a.op is Op.TRANSPOSE:          # (A.T).T -> A
                out = a.parents[0]
        elif node.op is Op.MATMUL:
            a, b = parents[:2]
            extras = parents[2:]           # epilogue operands (re-optimize)
            epi = matmul_epilogue(node.payload)
            if epi is None and not extras and _is_eye(b) \
                    and a.dtype == node.dtype:
                out = a
            elif epi is None and not extras and _is_eye(a) \
                    and b.dtype == node.dtype:
                out = b
            else:
                flags0 = matmul_flags(node.payload)
                ta, tb = flags0
                while a.op is Op.TRANSPOSE:
                    a, ta = a.parents[0], not ta
                    report.transposes_folded += 1
                while b.op is Op.TRANSPOSE:
                    b, tb = b.parents[0], not tb
                    report.transposes_folded += 1
                if (a, b) != parents[:2] or (ta, tb) != flags0:
                    if epi is not None:
                        payload = epilogue_payload((ta, tb), epi)
                    else:
                        payload = (ta, tb) if ta or tb else None
                    out = ClusteredMatrix(Op.MATMUL, node.shape, node.dtype,
                                          parents=(a, b) + extras,
                                          payload=payload,
                                          name=node.name)

        if out is not None and out.op is not Op.MATMUL:
            report.identities_folded += 1
        if out is None:
            out = node if parents == node.parents else \
                ClusteredMatrix(node.op, node.shape, node.dtype,
                                parents=parents, payload=node.payload,
                                name=node.name)
        new[node.uid] = out
    return [new[r.uid] for r in roots]


# ---------------------------------------------------------------------------
# pass 2: common-subexpression elimination
# ---------------------------------------------------------------------------

def _value_payload_key(node: ClusteredMatrix):
    """Payload component of the CSE key — must distinguish different VALUES.

    INPUT data is keyed by array object identity; RANDOM by its seed.
    """
    if node.op is Op.INPUT:
        return ("input", id(node.payload))
    if node.op is Op.RANDOM:
        return ("seed", node.payload)
    if node.op is Op.FUSED:
        return node.payload
    if isinstance(node.payload, (str, int, float, tuple, type(None))):
        return node.payload
    return id(node.payload)


def cse_many(roots: Sequence[ClusteredMatrix],
             report: FusionReport) -> List[ClusteredMatrix]:
    """CSE over the union DAG of several roots — the shared-CSE half of
    ``compute_many``: a subexpression common to two roots is computed
    once in the merged program."""
    canon: Dict[tuple, ClusteredMatrix] = {}
    new: Dict[int, ClusteredMatrix] = {}

    for node in topo_order_many(roots):
        parents = tuple(new[p.uid] for p in node.parents)
        key = (node.op, node.shape, str(node.dtype),
               _value_payload_key(node), tuple(p.uid for p in parents))
        hit = canon.get(key)
        if hit is not None:
            report.cse_merged += 1
            new[node.uid] = hit
            continue
        out = node if parents == node.parents else \
            ClusteredMatrix(node.op, node.shape, node.dtype, parents=parents,
                            payload=node.payload, name=node.name)
        canon[key] = out
        new[node.uid] = out
    return [new[r.uid] for r in roots]


# ---------------------------------------------------------------------------
# pass 3: elementwise-chain fusion
# ---------------------------------------------------------------------------

def _consumers(roots: Sequence[ClusteredMatrix]) -> Dict[int, Set[int]]:
    cons: Dict[int, Set[int]] = {r.uid: set() for r in roots}
    for node in topo_order_many(roots):
        cons.setdefault(node.uid, set())
        for p in node.parents:
            cons.setdefault(p.uid, set()).add(node.uid)
    return cons


def fuse_elementwise_many(roots: Sequence[ClusteredMatrix],
                          report: FusionReport) -> List[ClusteredMatrix]:
    """Multi-root elementwise fusion.  A root's value is an OUTPUT of the
    merged program, so a root node is never inlined into a consumer's
    region (it may still root its own region and swallow its upstream
    chain)."""
    order = topo_order_many(roots)
    by_uid = {n.uid: n for n in order}
    cons = _consumers(roots)
    root_uids = {r.uid for r in roots}

    # region_of[uid] = uid of the region root this node is inlined into
    region_of: Dict[int, int] = {}
    for node in reversed(order):            # root first
        if node.op not in ELEMENTWISE_OPS:
            continue
        cs = cons[node.uid]
        if len(cs) == 1 and node.uid not in root_uids:
            (c,) = cs
            if by_uid[c].op in ELEMENTWISE_OPS:
                # inline into the consumer's region
                region_of[node.uid] = region_of.get(c, c)
                continue
        region_of[node.uid] = node.uid      # roots its own region

    members: Dict[int, List[ClusteredMatrix]] = {}
    for node in order:                      # topological member order
        r = region_of.get(node.uid)
        if r is not None:
            members.setdefault(r, []).append(node)

    new: Dict[int, ClusteredMatrix] = {}
    for node in order:
        r = region_of.get(node.uid)
        if r is not None and r != node.uid:
            continue                        # interior node: no standalone copy
        if r is None or len(members[r]) == 1:
            parents = tuple(new[p.uid] for p in node.parents)
            new[node.uid] = node if parents == node.parents else \
                ClusteredMatrix(node.op, node.shape, node.dtype,
                                parents=parents, payload=node.payload,
                                name=node.name)
            continue

        # build the FUSED node for this region
        region = members[r]
        region_uids = {m.uid for m in region}
        externals: List[ClusteredMatrix] = []
        ext_slot: Dict[int, int] = {}       # resolved-external uid -> slot
        instrs: List[tuple] = []
        instr_of: Dict[int, int] = {}       # member/external uid -> instr idx

        def operand(p: ClusteredMatrix) -> int:
            if p.uid in region_uids:
                return instr_of[p.uid]
            q = new[p.uid]
            if q.uid not in ext_slot:
                ext_slot[q.uid] = len(externals)
                externals.append(q)
                instrs.append(("in", ext_slot[q.uid]))
                instr_of[q.uid] = len(instrs) - 1
            return instr_of[q.uid]

        for m in region:
            if m.op is Op.EWISE:
                ins = ("ewise", m.payload, operand(m.parents[0]))
            elif m.op is Op.SCALE:
                kind, s = m.payload
                ins = ("scale", kind, s, operand(m.parents[0]))
            else:
                opname = {Op.ADD: "add", Op.SUB: "sub",
                          Op.EWMUL: "ewmul"}[m.op]
                ins = (opname, operand(m.parents[0]), operand(m.parents[1]))
            instrs.append(ins)
            instr_of[m.uid] = len(instrs) - 1

        fused = ClusteredMatrix(Op.FUSED, node.shape, node.dtype,
                                parents=tuple(externals),
                                payload=tuple(instrs), name=node.name)
        report.fused_regions += 1
        report.fused_ops += len(region)
        new[node.uid] = fused

    return [new[r.uid] for r in roots]


# ---------------------------------------------------------------------------
# pass 4: matmul-epilogue fusion
# ---------------------------------------------------------------------------

def _as_epilogue_prog(node: ClusteredMatrix,
                      slot_of: Dict[int, int]) -> tuple:
    """Rewrite ``node`` (a FUSED region or a single elementwise op) as an
    epilogue program whose ``("in", k)`` slots follow ``slot_of`` —
    parent uid -> epilogue input slot (0 = the matmul accumulator)."""
    if node.op is Op.FUSED:
        out = []
        for ins in node.payload:
            if ins[0] == "in":
                out.append(("in", slot_of[node.parents[ins[1]].uid]))
            else:
                out.append(ins)
        return tuple(out)
    # single elementwise node: synthesize the minimal program
    slots = [slot_of[p.uid] for p in node.parents]
    instrs: List[tuple] = []
    idx_of: Dict[int, int] = {}          # input slot -> instruction index
    for s in slots:
        if s not in idx_of:
            instrs.append(("in", s))
            idx_of[s] = len(instrs) - 1
    ops = [idx_of[s] for s in slots]
    if node.op is Op.EWISE:
        instrs.append(("ewise", node.payload, ops[0]))
    elif node.op is Op.SCALE:
        kind, s = node.payload
        instrs.append(("scale", kind, s, ops[0]))
    else:
        opname = {Op.ADD: "add", Op.SUB: "sub", Op.EWMUL: "ewmul"}[node.op]
        instrs.append((opname, ops[0], ops[1]))
    return tuple(instrs)


def fuse_matmul_epilogues(root: ClusteredMatrix,
                          report: FusionReport) -> ClusteredMatrix:
    """Single-root wrapper over :func:`fuse_matmul_epilogues_many`."""
    return fuse_matmul_epilogues_many((root,), report)[0]


def fuse_matmul_epilogues_many(roots: Sequence[ClusteredMatrix],
                               report: FusionReport
                               ) -> List[ClusteredMatrix]:
    """Fold elementwise consumers of single-consumer MATMULs into the
    matmul as an epilogue program (runs after elementwise fusion, so a
    whole chain like ``relu(A@B + C)`` arrives as ONE FUSED node).

    Candidate anchor: a MATMUL parent of an elementwise/FUSED node that
    (a) has no epilogue yet, (b) is consumed ONLY by this node, (c) is not
    itself a program root, and (d) has the consumer's shape (elementwise
    ops preserve shape, so this always holds for direct operands).  The
    consumer is rewritten into the matmul: parents become
    ``(A, B, *other_operands)`` and the payload carries the epilogue
    program with slot 0 bound to the accumulated ``C`` tile.  Only ONE
    matmul is absorbed per region — other matmul operands stay
    materialised inputs (epilogue extras)."""
    order = topo_order_many(roots)
    cons = _consumers(roots)
    root_uids = {r.uid for r in roots}
    new: Dict[int, ClusteredMatrix] = {}

    for node in order:
        parents = tuple(new[p.uid] for p in node.parents)
        out: Optional[ClusteredMatrix] = None

        mi = None
        if node.op is Op.FUSED or node.op in ELEMENTWISE_OPS:
            for i, (po, pn) in enumerate(zip(node.parents, parents)):
                if (pn.op is Op.MATMUL
                        and matmul_epilogue(pn.payload) is None
                        and po.uid not in root_uids
                        and cons.get(po.uid) == {node.uid}
                        and pn.shape == node.shape):
                    mi = i
                    break
        if mi is not None:
            anchor = parents[mi]
            # epilogue input slots: 0 = accumulator; 1.. = the region's
            # other external operands, in first-use order.  Keyed by the
            # PRE-pass parent uid so a CSE-duplicated anchor operand
            # (e.g. ``M + M``) maps every occurrence to slot 0.
            extras: List[ClusteredMatrix] = []
            slot_of: Dict[int, int] = {node.parents[mi].uid: 0}
            for po, pn in zip(node.parents, parents):
                if po.uid not in slot_of:
                    slot_of[po.uid] = 1 + len(extras)
                    extras.append(pn)
            prog = _as_epilogue_prog(node, slot_of)
            out = ClusteredMatrix(
                Op.MATMUL, node.shape, node.dtype,
                parents=tuple(anchor.parents) + tuple(extras),
                payload=epilogue_payload(matmul_flags(anchor.payload), prog),
                name=node.name)
            report.epilogues_fused += 1
            report.epilogue_ops += fused_op_count(prog)

        if out is None:
            out = node if parents == node.parents else \
                ClusteredMatrix(node.op, node.shape, node.dtype,
                                parents=parents, payload=node.payload,
                                name=node.name)
        new[node.uid] = out

    return [new[r.uid] for r in roots]


# ---------------------------------------------------------------------------
# the pass pipeline
# ---------------------------------------------------------------------------

def optimize(root: ClusteredMatrix
             ) -> Tuple[ClusteredMatrix, FusionReport]:
    """Run all rewrite passes; returns (optimized root, report)."""
    roots, report = optimize_many((root,))
    return roots[0], report


def optimize_many(roots: Sequence[ClusteredMatrix]
                  ) -> Tuple[List[ClusteredMatrix], FusionReport]:
    """Optimize several roots as ONE program: every pass (identity folds,
    CSE, elementwise fusion, matmul-epilogue fusion) runs over the union
    DAG, so subexpressions shared *across* roots are merged — the
    ``compute_many`` shared-CSE contract."""
    report = FusionReport(nodes_before=len(topo_order_many(roots)))
    roots = fold_identities_many(roots, report)
    roots = cse_many(roots, report)
    roots = fuse_elementwise_many(roots, report)
    roots = fuse_matmul_epilogues_many(roots, report)
    report.nodes_after = len(topo_order_many(roots))
    return list(roots), report


# ---------------------------------------------------------------------------
# FUSED program interpreter (shared by the executors + the eager oracle)
# ---------------------------------------------------------------------------

_BINARY = {"add": torch.add, "sub": torch.sub, "ewmul": torch.mul}


def fused_op_count(prog: Sequence[tuple]) -> int:
    """Number of arithmetic instructions in a FUSED program."""
    return sum(1 for ins in prog if ins[0] != "in")


def fused_flops(prog: Sequence[tuple], m: int, n: int) -> int:
    """Flop estimate matching the unfused per-kind accounting."""
    f = 0
    for ins in prog:
        if ins[0] == "in":
            continue
        f += (4 if ins[0] == "ewise" else 1) * m * n
    return f


def eval_fused(prog: Sequence[tuple], inputs: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """Interpret a FUSED tile program over tensors (last instr = output).

    Works on any leading batch shape (the wave executor passes stacked
    tiles).  Binary ops promote like NumPy; input tensors are never
    written.
    """
    vals: List[torch.Tensor] = []
    for ins in prog:
        kind = ins[0]
        if kind == "in":
            vals.append(inputs[ins[1]])
        elif kind == "ewise":
            vals.append(EWISE_FNS[ins[1]](vals[ins[2]]))
        elif kind == "scale":
            vals.append(apply_scale(ins[1], vals[ins[3]], ins[2]))
        else:
            vals.append(_BINARY[kind](vals[ins[1]], vals[ins[2]]))
    return vals[-1]


# ---------------------------------------------------------------------------
# structural signature (plan-cache key)
# ---------------------------------------------------------------------------

def _structure_payload_key(node: ClusteredMatrix):
    """Payload component of the *structural* signature.

    Unlike the CSE key this deliberately ignores leaf VALUES (input tensor
    identity, random seed): the tiled program and schedule depend only on
    structure and shapes, and a cache hit rebinds the leaves.
    """
    if node.op in (Op.INPUT, Op.RANDOM):
        return None
    if isinstance(node.payload, (str, int, float, tuple, type(None))):
        return node.payload
    return str(node.payload)


def structural_signature(root: ClusteredMatrix) -> tuple:
    """Canonical hashable description of the DAG's structure + shapes."""
    return structural_signature_many((root,))


def structural_signature_many(roots: Sequence[ClusteredMatrix]) -> tuple:
    """Structural signature of a multi-root program: the union DAG's
    node signature plus each root's index into it."""
    index: Dict[int, int] = {}
    sig: List[tuple] = []
    for i, node in enumerate(topo_order_many(roots)):
        index[node.uid] = i
        sig.append((node.op.value, node.shape, str(node.dtype),
                    _structure_payload_key(node),
                    tuple(index[p.uid] for p in node.parents)))
    return tuple(sig) + (("roots",) + tuple(index[r.uid] for r in roots),)


def leaves_in_order_many(roots: Sequence[ClusteredMatrix]
                         ) -> List[ClusteredMatrix]:
    """Leaves in canonical topo order — the rebinding contract between two
    DAGs with equal structural signatures."""
    return [n for n in topo_order_many(roots) if n.op in LEAF_OPS]
