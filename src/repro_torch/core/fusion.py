"""Graph fusion pass: detect dw->pw chains for the fused block kernels.

The paper's scheduler co-executes a depthwise layer on the p-core with the
neighbouring pointwise layers on the c-core so the intermediate feature map
never leaves the chip (§V).  This pass is the compiler half of that story
for the execution path: it walks a ``LayerGraph`` in topological order
and groups layers that ``repro_torch.kernels.fused_block`` can run in a
single kernel launch (copy of ``repro/core/fusion.py``):

  pw_dw_pw   1x1 conv (expand) -> dwconv -> 1x1 conv (project), the
             MobileNet-v2 inverted residual.  Matched first so the expand
             conv is not left behind as a singleton.
  dw_pw      dwconv -> 1x1 conv, the MobileNet-v1 separable block (also
             covers v2's t=1 block).
  single     everything else (regular convs, fc, fan-out nodes).

A chain only fuses when it is *linear* in the graph: each producer's sole
consumer is the next layer in the chain (a feature map with a second
consumer must be materialized anyway, so fusing would duplicate work).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.graph import LayerGraph, LayerSpec


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """One execution unit of the fused plan."""

    kind: str                   # 'single' | 'dw_pw' | 'pw_dw_pw'
    layers: tuple[str, ...]

    def __iter__(self):
        return iter(self.layers)


def _is_pw(l: LayerSpec) -> bool:
    return (l.op == "conv" and l.K_h == 1 and l.K_w == 1 and l.stride == 1
            and l.pad == 0)


def _linear_next(graph: LayerGraph, name: str) -> str | None:
    """Sole successor of ``name`` that has ``name`` as its sole
    predecessor, else None."""
    succ = graph.successors(name)
    if len(succ) != 1:
        return None
    if graph.predecessors(succ[0]) != [name]:
        return None
    return succ[0]


def plan_fusion(graph: LayerGraph) -> list[FusionGroup]:
    """Greedy fusion plan over the graph in topological order."""
    order = graph.topological_order()
    consumed: set[str] = set()
    plan: list[FusionGroup] = []
    for l in order:
        if l.name in consumed:
            continue
        group = _match(graph, l)
        plan.append(group)
        consumed.update(group.layers)
    return plan


def _match(graph: LayerGraph, l: LayerSpec) -> FusionGroup:
    # pw-expand -> dw -> pw-project (matched first: see module docstring)
    if _is_pw(l):
        dn = _linear_next(graph, l.name)
        if dn is not None and graph.layer(dn).op == "dwconv":
            pn = _linear_next(graph, dn)
            if pn is not None and _is_pw(graph.layer(pn)):
                return FusionGroup("pw_dw_pw", (l.name, dn, pn))
    # dw -> pw
    if l.op == "dwconv":
        pn = _linear_next(graph, l.name)
        if pn is not None and _is_pw(graph.layer(pn)):
            return FusionGroup("dw_pw", (l.name, pn))
    return FusionGroup("single", (l.name,))


def fused_layer_counts(graph: LayerGraph) -> dict[str, int]:
    """Summary used by benchmarks / tests: group-kind -> count."""
    counts: dict[str, int] = {}
    for g in plan_fusion(graph):
        counts[g.kind] = counts.get(g.kind, 0) + 1
    return counts
