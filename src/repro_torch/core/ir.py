"""Courier IR — the coarse-grained dataflow representation (paper Sect. II-B).

The IR mirrors what Courier-FPGA's Frontend extracts from a running binary
(paper Steps 1-5): an *ordered* function-call graph whose nodes are
library-level functions and whose edges carry the observed input/output data
metadata (shape, dtype == the paper's "bit-depth", byte size) plus a profile
log (processing time, absolute start/end times).

Nodes are kept in chronological (traced) order, exactly like the paper's
Fig. 4 graph; the Pipeline Generator partitions this order into contiguous
stages.  Users may inspect and edit the IR (paper Steps 6-7) before the
Backend builds the pipeline.

Dtypes are stored under their numpy names (``"float32"``, ``"bfloat16"``),
never as ``"torch.float32"``, so an IR written by either framework reads in
the other.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Any, Sequence

from .placement import Placement

# element size by numpy dtype name; bfloat16 has no numpy dtype of its own
ITEMSIZE = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "complex64": 8, "complex128": 16,
}


def dtype_name(dtype: Any) -> str:
    """Numpy name of a torch dtype, numpy dtype or dtype string."""
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    aliases = {"float": "float32", "half": "float16", "double": "float64",
               "long": "int64", "int": "int32", "short": "int16"}
    name = aliases.get(name, name)
    if name not in ITEMSIZE:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def flatten(tree: Any) -> list[Any]:
    """Leaves of nested tuples, lists and dicts (dict values in key order)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=str) for leaf in flatten(tree[k])]
    return [tree]


# --------------------------------------------------------------------------- #
# Values (edges)
# --------------------------------------------------------------------------- #
@dataclass
class Value:
    """An edge in the call graph: one observed array in/out of a function.

    ``shape``/``dtype`` correspond to the paper's ``height x width x
    bit-depth x channels`` node annotation; ``nbytes`` is what the Pipeline
    Generator uses for port sizing / communication-cost estimates.
    """

    name: str
    shape: tuple[int, ...]
    dtype: str
    producer: str | None = None          # node name that wrote it (None = graph input)
    consumers: list[str] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * ITEMSIZE[self.dtype]

    @property
    def bit_depth(self) -> int:
        """The paper's AXI port-width input: bits per element."""
        return ITEMSIZE[self.dtype] * 8


# --------------------------------------------------------------------------- #
# Nodes (function calls)
# --------------------------------------------------------------------------- #
@dataclass
class Node:
    """One traced library-function call.

    ``fn_key`` is the database lookup key (paper: the function *name* used to
    search the hardware-module database).  ``time_ms`` is the profiled
    processing time from the Frontend; ``placement`` is filled by the Backend
    after database lookup.  Legacy string placements ("hw"/"sw") are parsed
    on construction.
    """

    name: str                              # unique instance name, e.g. "cvtColor_0"
    fn_key: str                            # database key, e.g. "cvtColor"
    inputs: list[str] = field(default_factory=list)    # Value names
    outputs: list[str] = field(default_factory=list)   # Value names
    # keyword binding per input: parallel to ``inputs``; None = positional,
    # a string = the keyword the array was passed under at trace time.
    # Empty list means all-positional.
    input_kw: list[str | None] = field(default_factory=list)
    params: dict[str, Any] = field(default_factory=dict)  # static call params
    time_ms: float | None = None           # profiled processing time
    # provenance of time_ms: "estimate" (roofline, may be overwritten by
    # better sources) or "profile" (measured; never overwritten by one)
    time_source: str = "estimate"
    t_start: float | None = None           # absolute start (profile log)
    t_end: float | None = None             # absolute end   (profile log)
    flops: float | None = None             # analytical cost-model annotations
    bytes_rw: float | None = None
    placement: Placement = field(default_factory=Placement)
    # TBB filter-kind marker: a serial-only function is not side-effect
    # safe, so any stage containing it keeps exactly ONE worker
    serial_only: bool = False
    fused_from: list[str] = field(default_factory=list)  # names of fused originals
    # per-part input shapes recorded at fusion time, one list per fused part
    fused_input_shapes: list[list[tuple[int, ...]]] = field(default_factory=list)
    # per-part static call params recorded at fusion time
    fused_params: list[dict[str, Any]] = field(default_factory=list)
    # per-part dataflow routing recorded at fusion time: each part's input /
    # output value names (a fused node's own ``inputs`` are the run's
    # external inputs)
    fused_part_inputs: list[list[str]] = field(default_factory=list)
    fused_part_outputs: list[list[str]] = field(default_factory=list)
    # keyword binding per part input recorded at fusion time
    fused_part_kw: list[list[str | None]] = field(default_factory=list)
    # stateful-slot binding: the mutable per-request state this call touches
    # (None for pure functions); implies serial_only and sw placement
    state: str | None = None

    def __post_init__(self) -> None:
        if not isinstance(self.placement, Placement):
            self.placement = Placement.parse(self.placement)


# --------------------------------------------------------------------------- #
# Graph
# --------------------------------------------------------------------------- #
class CourierIR:
    """Ordered function-call graph with I/O data (paper Fig. 4)."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self.nodes: list[Node] = []                 # chronological order
        self.values: dict[str, Value] = {}
        self.graph_inputs: list[str] = []
        self.graph_outputs: list[str] = []
        # value name -> tensor for graph inputs the Frontend discovered
        # mid-trace (closure-captured weights/constants); the backend stages
        # them from here so callers only feed the per-token arguments
        self.captured: dict[str, Any] = {}

    # -- construction ------------------------------------------------------ #
    def add_value(self, name: str, shape: Sequence[int], dtype: Any,
                  producer: str | None = None) -> Value:
        v = Value(name=name, shape=tuple(int(s) for s in shape),
                  dtype=dtype_name(dtype), producer=producer)
        self.values[name] = v
        return v

    def add_node(self, node: Node) -> Node:
        for i in node.inputs:
            if i not in self.values:
                raise KeyError(f"node {node.name}: unknown input value {i!r}")
            self.values[i].consumers.append(node.name)
        for o in node.outputs:
            if o not in self.values:
                raise KeyError(f"node {node.name}: unknown output value {o!r}")
            self.values[o].producer = node.name
        self.nodes.append(node)
        return node

    # -- queries ------------------------------------------------------------ #
    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def total_time_ms(self) -> float:
        return float(sum(n.time_ms or 0.0 for n in self.nodes))

    def is_linear_chain(self) -> bool:
        """True if every node's outputs feed only the next node (or the
        graph's outputs): the paper's fusion rule, "no branch nor loop",
        on which the fusion pass and the stage partitioner operate."""
        index = {n.name: i for i, n in enumerate(self.nodes)}
        return all(index[c] == i + 1
                   for i, n in enumerate(self.nodes) for o in n.outputs
                   for c in self.values[o].consumers)

    def consumers_of(self, node: Node) -> list[Node]:
        """The nodes that read ``node``'s outputs, output by output, in
        the order each value records them (a node reading two of them is
        listed twice)."""
        return [self.node(c) for o in node.outputs
                for c in self.values[o].consumers]

    def validate(self) -> None:
        """Topological sanity: every input is produced before use."""
        produced = set(self.graph_inputs)
        for n in self.nodes:
            for i in n.inputs:
                if i not in produced:
                    raise ValueError(
                        f"IR not causally ordered: {n.name} reads {i!r} "
                        f"before it is produced")
            produced.update(n.outputs)
        for o in self.graph_outputs:
            if o not in produced:
                raise ValueError(f"graph output {o!r} never produced")

    # -- paper Fig.4-style rendering ---------------------------------------- #
    def render(self) -> str:
        """ASCII rendering of the chronological call graph incl. I/O data."""
        lines = [f"CourierIR({self.name})  total={self.total_time_ms():.1f} ms"]
        for vn in self.graph_inputs:
            v = self.values[vn]
            tag = " (captured)" if vn in self.captured else ""
            lines.append(f"  (in)  {vn}: {v.shape} {v.dtype}  [{v.nbytes} B]{tag}")
        for n in self.nodes:
            t = f"{n.time_ms:.3f} ms" if n.time_ms is not None else "?"
            p = Placement.parse(n.placement).short()
            lines.append(f"  [{p:^10s}] {n.name} <{n.fn_key}>  {t}")
            for o in n.outputs:
                v = self.values[o]
                lines.append(f"      -> {o}: {v.shape} {v.dtype}  [{v.nbytes} B]")
        for vn in self.graph_outputs:
            lines.append(f"  (out) {vn}")
        return "\n".join(lines)

    # -- (de)serialization: the same JSON as the JAX package's IR ------------ #
    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "nodes": [asdict(n) for n in self.nodes],
            "values": {k: asdict(v) for k, v in self.values.items()},
            "graph_inputs": self.graph_inputs,
            "graph_outputs": self.graph_outputs,
            # names only — the tensors themselves are runtime state, not IR
            "captured": sorted(self.captured),
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "CourierIR":
        d = json.loads(s)
        ir = cls(d["name"])
        for k, v in d["values"].items():
            v = dict(v)
            v["shape"] = tuple(v["shape"])
            v["dtype"] = dtype_name(v["dtype"])
            ir.values[k] = Value(**v)
        for n in d["nodes"]:
            ir.nodes.append(Node(**{**n, "inputs": list(n["inputs"]),
                                    "outputs": list(n["outputs"])}))
        ir.graph_inputs = list(d["graph_inputs"])
        ir.graph_outputs = list(d["graph_outputs"])
        return ir


def linear_ir(name: str, fn_keys: Sequence[str], times_ms: Sequence[float],
              io_shape: Sequence[int] = (1,), dtype: str = "float32") -> CourierIR:
    """Convenience constructor: a linear chain IR from (fn_key, time) pairs —
    replays the *paper's own profile* (Table I) through the generator."""
    if len(fn_keys) != len(times_ms):
        raise ValueError(f"{len(fn_keys)} keys vs {len(times_ms)} times")
    ir = CourierIR(name)
    ir.add_value("d0", io_shape, dtype)
    ir.graph_inputs = ["d0"]
    prev = "d0"
    for i, (k, t) in enumerate(zip(fn_keys, times_ms)):
        out = f"d{i+1}"
        ir.add_value(out, io_shape, dtype)
        ir.add_node(Node(name=f"{k}_{i}", fn_key=k, inputs=[prev],
                         outputs=[out], time_ms=float(t)))
        prev = out
    ir.graph_outputs = [prev]
    ir.validate()
    return ir
