"""Step-program IR: one uniform execution representation of the CNN zoo.

Port of ``repro/dualcore/program.py``, for the paper's three networks, and
the port's own steps for EfficientNet (``models/zoo.py``).  A network is
a flat list of :class:`Step` objects; each step covers one or more graph
layers (a fused block is one step), reads and writes named buffers in an
environment dict, and runs itself given the parameter dict.
``repro_torch.models.cnn`` runs the whole program in order (the sequential
forward); ``repro_torch.dualcore.runtime`` partitions the same steps into
alternating c-/p-core groups and pipelines images through them, so both
paths give the same bits.

Buffer conventions: the main chain flows through ``"h"``; the final logits
land in ``"out"``; SqueezeNet fire modules use ``"sq"``/``"e1"``; the
MobileNet-v2 and EfficientNet per-layer paths stash the block input in
``"res"`` for the residual add; an EfficientNet block's SE step reads the
depthwise output from ``"h"`` and writes it back gated (in place on the
card).  ``collect`` dicts receive activation *shapes* (as tuples).

The reference's ``use_pallas`` switch becomes dispatch by tensor device: a
step calls the kernel wrappers, which launch the CUDA kernels on CUDA
tensors and run the plain versions on CPU tensors.  ``plain=True`` builds
the steps over the plain versions on any device: ``chip_smoke.py`` holds
the kernel forward against it on the card; the main path never uses it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import (FusionGroup, _is_pw, _linear_next,
                                     plan_fusion)
from repro_torch.core.graph import LayerGraph, LayerSpec
from repro_torch.kernels.conv_gemm.ops import conv2d_gemm
from repro_torch.kernels.conv_gemm.ref import conv2d_ref
from repro_torch.kernels.depthwise.ops import depthwise
from repro_torch.kernels.depthwise.ref import depthwise_conv2d_ref
from repro_torch.kernels.fused_block.ops import (fused_dw_pw,
                                                 fused_inverted_residual)
from repro_torch.kernels.fused_block.ref import (fused_dw_pw_ref,
                                                 fused_pw_dw_pw_ref)
from repro_torch.kernels.se.ops import squeeze_excite, squeeze_excite_ref
from repro_torch.models.zoo import get_graph

Params = dict[str, dict[str, torch.Tensor]]
Env = dict[str, torch.Tensor]


def run_layer(l: LayerSpec, x: torch.Tensor, p: dict[str, torch.Tensor],
              act: str | None, plain: bool = False) -> torch.Tensor:
    """One graph layer: the kernel wrappers, or the plain versions."""
    if l.op == "dwconv":
        fn = depthwise_conv2d_ref if plain else depthwise
        return fn(x, p["w"], p["b"], stride=l.stride, pad=l.pad, act=act)
    fn = conv2d_ref if plain else conv2d_gemm
    return fn(x, p["w"], p["b"], stride=l.stride, pad=l.pad, act=act)


def avgpool_all(x: torch.Tensor) -> torch.Tensor:
    """Global average pool of an NHWC map, keeping (N, 1, 1, C)."""
    return torch.mean(x, dim=(1, 2), keepdim=True)


def maxpool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """NHWC max pool without padding ("VALID"), contiguous NHWC out."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _pad_pool(x: torch.Tensor) -> torch.Tensor:
    """SqueezeNet v1.1 pool: pad bottom/right with -inf so the 2x stride
    covers the map (asymmetric, as the reference pads)."""
    return maxpool(F.pad(x, (0, 0, 0, 1, 0, 1), value=float("-inf")))


def mbv1_act(name: str) -> str | None:
    """MobileNet v1 activation of layer ``name``."""
    return None if name == "fc" else "relu6"


def mbv2_act(name: str) -> str | None:
    """MobileNet v2 activation of layer ``name``."""
    if name in ("fc",) or name.endswith("_project"):
        return None                 # linear bottleneck / classifier head
    return "relu6"


def sqz_act(name: str) -> str | None:
    """SqueezeNet activation of layer ``name``."""
    return "relu"


def effnet_act(name: str) -> str | None:
    """EfficientNet activation of layer ``name``: silu on every layer but
    the projections and the classifier; the SE gate's reduce FC takes
    silu and its expand FC sigmoid (both inside the SE kernel)."""
    if name == "fc" or name.endswith("_project"):
        return None
    if name.endswith("_se_expand"):
        return "sigmoid"
    return "silu"


ACT_OF: dict[str, Callable[[str], str | None]] = {
    "mobilenet_v1": mbv1_act,
    "mobilenet_v2": mbv2_act,
    "squeezenet": sqz_act,
    "efficientnet": effnet_act,
}


def family(name: str) -> str:
    """The ``ACT_OF`` and ``_BUILDERS`` key of graph ``name``: the name of
    a paper model, or ``"efficientnet"`` for an EfficientNet at any
    scaling (``zoo.efficientnet_graph`` names each ``efficientnet...``)."""
    return "efficientnet" if name.startswith("efficientnet") else name


# --------------------------------------------------------------------------
# Step / Program
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Step:
    """One execution unit: reads buffers from the env, writes buffers back.

    ``fn(params, env, collect)`` mutates ``env`` in place; ``collect`` (when
    not None) receives ``name -> shape`` entries.  ``layers`` are the graph
    layers this step computes: the hook the scheduler's core assignment
    uses.
    """

    name: str
    layers: tuple[str, ...]
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    fn: Callable[[Params, Env, dict | None], None]

    def __repr__(self) -> str:
        return f"Step({self.name}, layers={list(self.layers)})"


@dataclasses.dataclass
class Program:
    """Ordered step list + the graph and activation map it was built from."""

    graph: LayerGraph
    steps: list[Step]
    act_of: Callable[[str], str | None]
    plain: bool = False

    def run(self, params: Params, x: torch.Tensor,
            collect: dict | None = None) -> torch.Tensor:
        """Sequential execution: the plain forward pass."""
        env: Env = {"h": x}
        for s in self.steps:
            s.fn(params, env, collect)
        return env["out"]


def _shape(t: torch.Tensor) -> tuple[int, ...]:
    return tuple(t.shape)


# --------------------------------------------------------------------------
# step constructors (shared by the builders and the runtime's group fusion)
# --------------------------------------------------------------------------
def layer_step(graph: LayerGraph, name: str,
               act_of: Callable[[str], str | None],
               plain: bool = False) -> Step:
    """Plain single-layer step on the main chain."""
    l = graph.layer(name)
    act = act_of(name)

    def fn(params, env, collect):
        env["h"] = run_layer(l, env["h"], params[name], act, plain)
        if collect is not None:
            collect[name] = _shape(env["h"])

    return Step(name=name, layers=(name,), reads=("h",), writes=("h",),
                fn=fn)


def fused_step(graph: LayerGraph, kind: str, names: tuple[str, ...],
               act_of: Callable[[str], str | None],
               plain: bool = False) -> Step:
    """One fused-block launch (dw->pw or pw->dw->pw) as a step."""
    last = names[-1]

    if kind == "dw_pw":
        d, p = (graph.layer(nm) for nm in names)
        dw_pw = fused_dw_pw_ref if plain else fused_dw_pw

        def fn(params, env, collect):
            pd, pp = params[d.name], params[p.name]
            pw_w = pp["w"].reshape(pp["w"].shape[-2], pp["w"].shape[-1])
            env["h"] = dw_pw(env["h"], pd["w"], pd["b"], pw_w, pp["b"],
                             stride=d.stride, pad=d.pad,
                             dw_act=act_of(d.name), pw_act=act_of(p.name))
            if collect is not None:
                collect[last] = _shape(env["h"])

    elif kind == "pw_dw_pw":
        e, d, p = (graph.layer(nm) for nm in names)
        with_res = ("add" in p.fused and d.stride == 1 and e.C_i == p.C_o)
        pw_dw_pw = fused_pw_dw_pw_ref if plain else fused_inverted_residual

        def fn(params, env, collect):
            res = env["h"] if with_res else None
            pe, pd, pp = params[e.name], params[d.name], params[p.name]
            exp_w = pe["w"].reshape(pe["w"].shape[-2], pe["w"].shape[-1])
            proj_w = pp["w"].reshape(pp["w"].shape[-2], pp["w"].shape[-1])
            env["h"] = pw_dw_pw(
                env["h"], exp_w, pe["b"], pd["w"], pd["b"], proj_w,
                pp["b"], res, stride=d.stride, pad=d.pad,
                exp_act=act_of(e.name), dw_act=act_of(d.name),
                proj_act=act_of(p.name))
            if collect is not None:
                collect[last] = _shape(env["h"])

    else:
        raise ValueError(f"unknown fused step kind {kind!r}")

    return Step(name="+".join(names), layers=tuple(names), reads=("h",),
                writes=("h",), fn=fn)


def head_step(graph: LayerGraph, name: str,
              act_of: Callable[[str], str | None], avgpool_first: bool,
              plain: bool = False) -> Step:
    """Classifier head: optional global avgpool, the fc/conv layer, flatten
    into ``out``."""
    l = graph.layer(name)
    act = act_of(name)

    def fn(params, env, collect):
        h = env["h"]
        if avgpool_first:
            h = avgpool_all(h)
        h = run_layer(l, h, params[name], act, plain)
        if collect is not None:
            collect[name] = _shape(h)
        env["out"] = h.reshape(h.shape[0], -1)

    return Step(name=name, layers=(name,), reads=("h",), writes=("out",),
                fn=fn)


# --------------------------------------------------------------------------
# model builders
# --------------------------------------------------------------------------
def _fused_chain_steps(graph: LayerGraph,
                       act_of: Callable[[str], str | None],
                       plain: bool) -> list[Step]:
    """The fusion-plan path for the (almost) sequential nets: one fused
    launch per dw->pw / pw->dw->pw group, singles for the rest."""
    steps: list[Step] = []
    for grp in plan_fusion(graph):
        first = graph.layer(grp.layers[0])
        if grp.kind in ("dw_pw", "pw_dw_pw"):
            steps.append(fused_step(graph, grp.kind, grp.layers, act_of,
                                    plain))
        elif first.op == "fc" and "avgpool" in first.fused:
            steps.append(head_step(graph, first.name, act_of,
                                   avgpool_first=True, plain=plain))
        else:
            steps.append(layer_step(graph, first.name, act_of, plain))
    return steps


def _mbv1_steps(graph: LayerGraph, fuse: bool, plain: bool) -> list[Step]:
    if fuse:
        return _fused_chain_steps(graph, mbv1_act, plain)
    steps = [layer_step(graph, l.name, mbv1_act, plain)
             for l in graph.layers[:-1]]
    steps.append(head_step(graph, "fc", mbv1_act, avgpool_first=True,
                           plain=plain))
    return steps


def _residual_layer_step(graph: LayerGraph, name: str,
                         act_of: Callable[[str], str | None], stash: bool,
                         plain: bool) -> Step:
    """Per-layer step with the residual stash/add protocol: a ``stash``
    step records the block input, ``_project`` adds it back when the
    graph marks the block residual."""
    l = graph.layer(name)
    act = act_of(name)
    add = name.endswith("_project") and "add" in l.fused

    def fn(params, env, collect):
        h = env["h"]
        if stash:
            env["res"] = h          # block input, for the residual add
        out = run_layer(l, h, params[name], act, plain)
        if add and "res" in env and env["res"].shape == out.shape:
            out = out + env["res"]
        env["h"] = out
        if collect is not None:
            collect[name] = _shape(out)

    reads = ("h", "res") if add else ("h",)
    writes = ("h", "res") if stash else ("h",)
    return Step(name=name, layers=(name,), reads=reads, writes=writes,
                fn=fn)


def _mbv2_steps(graph: LayerGraph, fuse: bool, plain: bool) -> list[Step]:
    if fuse:
        return _fused_chain_steps(graph, mbv2_act, plain)
    # ``_expand`` stashes the block input (MobileNet v2's t = 1 block is
    # never residual)
    steps = [_residual_layer_step(graph, l.name, mbv2_act,
                                  l.name.endswith("_expand"), plain)
             for l in graph.layers[:-1]]
    steps.append(head_step(graph, "fc", mbv2_act, avgpool_first=True,
                           plain=plain))
    return steps


def se_step(graph: LayerGraph, block: str, plain: bool = False) -> Step:
    """Block ``block``'s SE gate as one step over its two FC layers: the
    gate of the depthwise output in ``"h"``, then ``"h"`` scaled by it
    (the SE kernel's two launches; in place on the card)."""
    r = graph.layer(f"{block}_se_reduce")
    e = graph.layer(f"{block}_se_expand")
    gate = squeeze_excite_ref if plain else squeeze_excite

    def fn(params, env, collect):
        pr, pe = params[r.name], params[e.name]
        h = env["h"]
        env["h"] = gate(h, pr["w"].reshape(r.C_i, r.C_o), pr["b"],
                        pe["w"].reshape(e.C_i, e.C_o), pe["b"])
        if collect is not None:
            collect[r.name] = (h.shape[0], 1, 1, r.C_o)
            collect[e.name] = (h.shape[0], 1, 1, e.C_o)

    return Step(name=f"{block}_se", layers=(r.name, e.name), reads=("h",),
                writes=("h",), fn=fn)


def _effnet_steps(graph: LayerGraph, fuse: bool, plain: bool) -> list[Step]:
    """EfficientNet: one step a layer, one SE step a block.  Each
    depthwise output feeds the SE gate and the projection, so the fusion
    plan is all singles and ``fuse`` changes nothing.  A block's first
    layer (its expansion, or its depthwise conv where t = 1) stashes the
    block input for the projection's residual add."""
    names = {l.name for l in graph.layers}
    steps = []
    for l in graph.layers[:-1]:
        if l.name.endswith("_se_expand"):
            continue
        if l.name.endswith("_se_reduce"):
            steps.append(se_step(graph, l.name[:-len("_se_reduce")], plain))
            continue
        block = l.name.rsplit("_", 1)[0]
        first = l.name.endswith("_expand") or (
            l.name.endswith("_dw") and f"{block}_expand" not in names)
        steps.append(_residual_layer_step(graph, l.name, effnet_act, first,
                                          plain))
    steps.append(head_step(graph, "fc", effnet_act, avgpool_first=True,
                           plain=plain))
    return steps


def _sqz_fire_steps(graph: LayerGraph, fire: str, pool_after: bool,
                    plain: bool) -> list[Step]:
    sq_l = graph.layer(f"{fire}_squeeze")
    e1_l = graph.layer(f"{fire}_e1x1")
    e3_l = graph.layer(f"{fire}_e3x3")

    def sq_fn(params, env, collect):
        env["sq"] = run_layer(sq_l, env["h"], params[sq_l.name], "relu",
                              plain)
        if collect is not None:
            collect[sq_l.name] = _shape(env["sq"])

    def e1_fn(params, env, collect):
        env["e1"] = run_layer(e1_l, env["sq"], params[e1_l.name], "relu",
                              plain)
        if collect is not None:
            collect[e1_l.name] = _shape(env["e1"])

    def e3_fn(params, env, collect):
        e3 = run_layer(e3_l, env["sq"], params[e3_l.name], "relu", plain)
        if collect is not None:
            collect[e3_l.name] = _shape(e3)
        h = torch.cat([env["e1"], e3], dim=-1)
        env["h"] = _pad_pool(h) if pool_after else h

    return [
        Step(f"{fire}_squeeze", (sq_l.name,), ("h",), ("sq",), sq_fn),
        Step(f"{fire}_e1x1", (e1_l.name,), ("sq",), ("e1",), e1_fn),
        Step(f"{fire}_e3x3", (e3_l.name,), ("sq", "e1"), ("h",), e3_fn),
    ]


def _sqz_steps(graph: LayerGraph, fuse: bool, plain: bool) -> list[Step]:
    # no dwconv layers -> the fusion plan is all singletons (``fuse`` is a
    # no-op)
    conv1 = graph.layer("conv1")

    def conv1_fn(params, env, collect):
        h = run_layer(conv1, env["h"], params["conv1"], "relu", plain)
        if collect is not None:
            collect["conv1"] = _shape(h)
        env["h"] = _pad_pool(h)

    steps = [Step("conv1", ("conv1",), ("h",), ("h",), conv1_fn)]
    pool_after = {"fire3", "fire5"}        # v1.1 pool placement
    for i in range(2, 10):
        steps += _sqz_fire_steps(graph, f"fire{i}",
                                 pool_after=f"fire{i}" in pool_after,
                                 plain=plain)
    conv10 = graph.layer("conv10")

    def conv10_fn(params, env, collect):
        h = run_layer(conv10, env["h"], params["conv10"], "relu", plain)
        if collect is not None:
            collect["conv10"] = _shape(h)
        env["out"] = avgpool_all(h).reshape(h.shape[0], -1)

    steps.append(Step("conv10", ("conv10",), ("h",), ("out",), conv10_fn))
    return steps


_BUILDERS = {
    "mobilenet_v1": _mbv1_steps,
    "mobilenet_v2": _mbv2_steps,
    "squeezenet": _sqz_steps,
    "efficientnet": _effnet_steps,
}


def build_program(name_or_graph: str | LayerGraph, *, fuse: bool = False,
                  plain: bool = False) -> Program:
    """Build the step program for one zoo model.

    ``fuse=False`` gives one step per layer (the sequential default, as the
    reference's default forward is per-layer); ``fuse=True`` runs the
    fusion plan's dw->pw / pw->dw->pw groups as single fused launches
    (K4 and K5).  ``plain=True`` builds every step, fused ones included,
    over the plain PyTorch versions: no kernel wrapper is reached.
    Programs by name are cached: steps close over specs and read params per
    call.
    """
    if isinstance(name_or_graph, str):
        return _cached_program(name_or_graph, bool(fuse), plain)
    return _build(name_or_graph, bool(fuse), plain)


@functools.lru_cache(maxsize=None)
def _cached_program(name: str, fuse: bool, plain: bool) -> Program:
    return _build(get_graph(name), fuse, plain)


def _build(graph: LayerGraph, fuse: bool, plain: bool) -> Program:
    key = family(graph.name)
    try:
        builder = _BUILDERS[key]
    except KeyError:
        raise KeyError(f"no step builder for graph {graph.name!r}; "
                       f"choices: {sorted(_BUILDERS)}") from None
    return Program(graph=graph, steps=builder(graph, fuse, plain),
                   act_of=ACT_OF[key], plain=plain)


def regroup_fused(program: Program,
                  groups: list[list[Step]]) -> list[list[Step]]:
    """Within-group fusion: given per-layer steps partitioned into core
    groups, re-run the fusion matcher *inside* each group so dw->pw chains
    that the schedule kept on one core run as single fused launches, while
    chains the schedule split across cores stay per-layer.

    Only plain main-chain steps fuse (single-layer, reads==writes==("h",));
    branch/head/residual steps pass through untouched.
    """
    graph, act_of = program.graph, program.act_of
    out: list[list[Step]] = []
    for grp in groups:
        fused: list[Step] = []
        i = 0
        while i < len(grp):
            s = grp[i]
            window = grp[i:i + 3]
            m = _match_in(graph, window) if _plain(s) else None
            if m is not None:
                fused.append(fused_step(graph, m.kind, m.layers, act_of,
                                        program.plain))
                i += len(m.layers)
            else:
                fused.append(s)
                i += 1
        out.append(fused)
    return out


def _plain(s: Step) -> bool:
    return (len(s.layers) == 1 and s.reads == ("h",)
            and s.writes == ("h",))


def _match_in(graph: LayerGraph,
              window: list[Step]) -> FusionGroup | None:
    """Fusion match constrained to consecutive plain steps of one group:
    the same fusability rules as ``core.fusion`` (_is_pw/_linear_next),
    with the whole chain kept inside the group."""
    chain = []
    for s in window:
        if not _plain(s):
            break
        chain.append(s.layers[0])
    sub = [graph.layer(n) for n in chain]

    def linear(a, b):                # b is a's sole consumer and vice versa
        return _linear_next(graph, a) == b

    if (len(sub) >= 3 and _is_pw(sub[0]) and sub[1].op == "dwconv"
            and _is_pw(sub[2]) and linear(chain[0], chain[1])
            and linear(chain[1], chain[2])):
        return FusionGroup("pw_dw_pw", tuple(chain[:3]))
    if (len(sub) >= 2 and sub[0].op == "dwconv" and _is_pw(sub[1])
            and linear(chain[0], chain[1])):
        return FusionGroup("dw_pw", tuple(chain[:2]))
    return None
