"""Layer-graph IR for the dual-OPU compiler (paper §III-C, Fig.3/Fig.4a).

Nodes are layers with the characteristic parameters the paper's models consume
(input feature-map H/W, input/output channels, kernel H/W, stride); edges are
data dependencies.  Consumed by tiling / latency / scheduling and by the
step programs of ``repro_torch.dualcore.program``.

The port keeps its own copy of ``repro/core/graph.py`` (no import of the
reference package), so both schedule from identical code.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# Layer op kinds understood by the dual-OPU models.  ``conv`` covers regular and
# pointwise (K=1) convolution; ``dwconv`` is depthwise; ``fc`` is a 1x1 conv on a
# 1x1 feature map; ``pool``/``add``/``concat`` are post-processing-unit ops that
# the overlay fuses into the compute pipeline (latency absorbed in L_post).
CONV_OPS = ("conv", "dwconv", "fc")
FUSED_OPS = ("pool", "avgpool", "maxpool", "add", "concat", "relu", "relu6")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer with the paper's characteristic parameters (§II, §IV)."""

    name: str
    op: str                      # 'conv' | 'dwconv' | 'fc'
    H: int                       # input feature-map height
    W: int                       # input feature-map width
    C_i: int                     # input channels
    C_o: int                     # output channels
    K_h: int = 1
    K_w: int = 1
    stride: int = 1
    pad: int = 0
    # Post-ops fused into this layer's pipeline (pool/activation/residual-add).
    fused: tuple = ()

    def __post_init__(self):
        if self.op not in CONV_OPS:
            raise ValueError(f"unsupported op {self.op!r} for {self.name!r}")
        if self.op == "dwconv" and self.C_i != self.C_o:
            raise ValueError(
                f"{self.name}: depthwise conv requires C_i == C_o "
                f"(got {self.C_i} vs {self.C_o})")

    # ---- derived quantities ------------------------------------------------
    @property
    def H_out(self) -> int:
        """Output height."""
        return max(1, (self.H + 2 * self.pad - self.K_h) // self.stride + 1)

    @property
    def W_out(self) -> int:
        """Output width."""
        return max(1, (self.W + 2 * self.pad - self.K_w) // self.stride + 1)

    @property
    def macs(self) -> int:
        """Multiply-accumulate count (N_op in Eq.1 counts MACs)."""
        pix = self.H_out * self.W_out
        if self.op == "dwconv":
            return pix * self.C_i * self.K_h * self.K_w
        return pix * self.C_o * self.C_i * self.K_h * self.K_w

    @property
    def ifm_elems(self) -> int:
        """Input feature-map elements."""
        return self.H * self.W * self.C_i

    @property
    def ofm_elems(self) -> int:
        """Output feature-map elements."""
        return self.H_out * self.W_out * self.C_o

    @property
    def weight_elems(self) -> int:
        """Weight elements."""
        if self.op == "dwconv":
            return self.K_h * self.K_w * self.C_i
        return self.K_h * self.K_w * self.C_i * self.C_o

    @property
    def bias_elems(self) -> int:
        """Bias elements."""
        return self.C_o

    @property
    def load_elems(self) -> int:
        """Numerator of Eq.5: ifm + weights + bias elements to load."""
        return self.ifm_elems + self.weight_elems + self.bias_elems

    def with_height(self, H: int, name_suffix: str = "") -> "LayerSpec":
        """Clone with a new input height (used by Alg.1 layer split)."""
        return dataclasses.replace(self, H=H, name=self.name + name_suffix)


@dataclasses.dataclass
class LayerGraph:
    """CNN graph G(V, E) (paper §V-A, Fig.4a)."""

    name: str
    layers: list[LayerSpec]
    # Edges as (producer_name, consumer_name).  Absent edges => sequential chain.
    edges: list[tuple[str, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        names = [l.name for l in self.layers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate layer names in graph {self.name}")
        self._index = {l.name: i for i, l in enumerate(self.layers)}
        if not self.edges:
            self.edges = [(a.name, b.name)
                          for a, b in zip(self.layers, self.layers[1:])]
        for a, b in self.edges:
            if a not in self._index or b not in self._index:
                raise ValueError(f"edge ({a},{b}) references unknown layer")

    def __len__(self) -> int:
        return len(self.layers)

    def layer(self, name: str) -> LayerSpec:
        """The layer called ``name``."""
        return self.layers[self._index[name]]

    def predecessors(self, name: str) -> list[str]:
        """Layers with an edge into ``name``."""
        return [a for a, b in self.edges if b == name]

    def successors(self, name: str) -> list[str]:
        """Layers with an edge out of ``name``."""
        return [b for a, b in self.edges if a == name]

    def topological_order(self) -> list[LayerSpec]:
        """Kahn topological sort; ties broken by definition order (paper uses
        topological order for group assignment, §V-A)."""
        indeg = {l.name: 0 for l in self.layers}
        for _, b in self.edges:
            indeg[b] += 1
        ready = [l.name for l in self.layers if indeg[l.name] == 0]
        out: list[str] = []
        while ready:
            # stable: pick the earliest-defined ready node
            ready.sort(key=lambda n: self._index[n])
            n = ready.pop(0)
            out.append(n)
            for s in self.successors(n):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(out) != len(self.layers):
            raise ValueError(f"graph {self.name} has a cycle")
        return [self.layer(n) for n in out]

    @property
    def total_macs(self) -> int:
        """MACs of the whole graph."""
        return sum(l.macs for l in self.layers)

    @property
    def total_params(self) -> int:
        """Weights and biases of the whole graph."""
        return sum(l.weight_elems + l.bias_elems for l in self.layers)

    def summary(self) -> str:
        """A per-layer table of the graph, as text."""
        rows = [f"{'name':<22}{'op':<8}{'HxW':<12}{'Ci->Co':<14}"
                f"{'K':<6}{'s':<3}{'MACs':>12}"]
        for l in self.layers:
            rows.append(
                f"{l.name:<22}{l.op:<8}{f'{l.H}x{l.W}':<12}"
                f"{f'{l.C_i}->{l.C_o}':<14}{f'{l.K_h}x{l.K_w}':<6}"
                f"{l.stride:<3}{l.macs:>12,}")
        rows.append(f"total MACs: {self.total_macs:,}  "
                    f"params: {self.total_params:,}")
        return "\n".join(rows)


def chain_graph(name: str, layers: Sequence[LayerSpec]) -> LayerGraph:
    """Build a purely sequential graph (MobileNets are almost purely
    sequential, §II)."""
    return LayerGraph(name=name, layers=list(layers))
