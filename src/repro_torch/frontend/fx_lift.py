"""Lift PyTorch computations into the PTX-like register IR.

The port's counterpart of `repro.frontend.jaxpr_lift`.  ``make_fx(fn,
tracing_mode="fake")`` gives the aten graph of a PyTorch function at static
example shapes (a `torch.fx.Graph`); this module lowers that graph into the
asm DSL of `repro_torch.core.ir` with the jaxpr lifter's emission, so the
whole LTRF compiler pipeline (interval formation, renumbering, prefetch
scheduling) and both simulator engines run on the port's own programs.  The
lowering models one GPU thread's tiled slice of the computation:

* each graph value (an fx node) is a virtual register (its resident tile);
* operand materialization (placeholders and tensor constants), reads
  (``index``, ``gather``, ...) and scan inputs become ``ld``; outputs and
  scatter-like writes become ``st``;
* ``mm``/``bmm``/``addmm``/``baddbmm``/``dot`` expand into a register-tiled
  inner loop over the contraction dimension;
* reductions expand into an accumulate loop over the reduced extent;
* ``higher_order.scan`` and ``higher_order.while_loop`` become labelled loops
  with finite trip counts (the simulator's branch model resolves them through
  the ``trips`` table) and loop-carried values get dedicated carry registers;
* ``higher_order.cond`` becomes an if/else diamond with a predicated branch;
* call-like wrappers (``wrap``, ``invoke_subgraph``,
  ``tag_activation_checkpoint``) are inlined;
* the few aten ops that are one node where the jnp function's jaxpr has
  several (``_softmax``, ``mean``, ``silu``, ``clamp``, ``where``,
  ``masked_fill``) are lowered as that jaxpr's primitive sequence
  (`_COMPOSITES`), so a function written in both packages lifts alike.

Shapes come from each node's ``meta["val"]`` (a fake tensor): nothing is
computed and CUDA is never initialized.  Virtual registers are unlimited;
`repro_torch.frontend.regalloc` lowers them to an architectural budget
afterwards.  Lifting is deterministic: the same function and example shapes
produce the identical program text.
"""
from __future__ import annotations

import operator
import re
from contextlib import contextmanager
from dataclasses import dataclass
from math import prod

import torch
from torch.fx import GraphModule, Node

from repro_torch.core.ir import Program, parse_asm

# Bump when the lowering changes shape: keys the lift memo in
# `repro_torch.core.plan_cache.cached_value` and the sweep store's entries
# of lifted workloads, so stale lifts never replay.
LIFT_REV = 1

# The jaxpr lifter's primitive classes, by jax primitive name: the steps of
# `_COMPOSITES` are jaxpr primitives and go through these.
_DATA_MOVEMENT = frozenset({
    "broadcast_in_dim", "reshape", "transpose", "squeeze", "expand_dims",
    "rev", "slice", "pad", "convert_element_type", "reduce_precision",
    "copy", "iota", "real", "imag",
})
_PASSTHROUGH = frozenset({"stop_gradient"})
_REDUCE_OPS = {
    "reduce_sum": "add", "reduce_max": "max", "reduce_min": "min",
    "reduce_prod": "mul", "reduce_and": "and", "reduce_or": "or",
    "argmax": "max", "argmin": "min",
    "cumsum": "add", "cumprod": "mul", "cummax": "max", "cummin": "min",
    "cumlogsumexp": "add",
}
# Friendlier opcode spellings for a few primitives (jax's, then aten's).
_RENAME = {"integer_pow": "pow", "select_n": "sel", "logistic": "sig",
           "square": "mul", "concatenate": "cat", "sigmoid": "sig"}
# Opcodes with special IR semantics that an ALU op must never shadow.
_IR_RESERVED = frozenset({"ld", "st", "bra", "call", "exit", "ret", "set"})

# The aten counterparts, by `OpOverloadPacket` name.
# Layout/dtype-only ops (and constant fills): a register-to-register move.
_ATEN_DATA_MOVEMENT = frozenset({
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "expand",
    "permute", "transpose", "t", "clone", "_to_copy", "alias", "detach",
    "slice", "select", "cat", "stack", "lift_fresh_copy",
    "full", "zeros", "ones", "arange", "scalar_tensor",
})
# Products -> the register-tiled contraction loop.
_ATEN_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "dot"})
# Reductions -> (accumulate op) loops.
_ATEN_REDUCE_OPS = {
    "sum": "add", "amax": "max", "amin": "min", "prod": "mul",
    "argmax": "max", "argmin": "min", "cumsum": "add", "cumprod": "mul",
    "logsumexp": "add",
}
# Long-latency reads / writes of off-chip data.
_ATEN_MEM_READ = frozenset({"index", "index_select", "gather", "embedding"})
_ATEN_MEM_WRITE = frozenset({
    "index_put", "scatter", "scatter_add", "slice_scatter", "select_scatter",
    "copy_",
})
# Call-like higher-order ops: their subgraph is inlined.
_CALLS = frozenset({"wrap", "invoke_subgraph", "tag_activation_checkpoint"})

# Aten ops lowered as the primitive sequence `jax.make_jaxpr` gives their jnp
# counterpart (jax 0.9).  Each step is (jaxpr primitive, *operands); an
# operand is an argument of the aten op by its schema name, the index of an
# earlier step, or "imm" (a literal).  A reduction step reduces the op's
# ``dim`` of ``self``.  "call_operand" is a literal passed into an inlined
# jaxpr call (``jit[name=clip]``), which the jaxpr lifter materializes.
_COMPOSITES = {
    # jax.nn.softmax(x, axis)
    "_softmax": (("reduce_max", "self"), ("max", "imm", 0),
                 ("broadcast_in_dim", 1), ("stop_gradient", 2),
                 ("sub", "self", 3), ("exp", 4), ("reduce_sum", 5),
                 ("broadcast_in_dim", 6), ("div", 5, 7)),
    # jnp.mean(x, axis, keepdims)
    "mean": (("reduce_sum", "self"), ("div", 0, "imm")),
    # jax.nn.silu(x)
    "silu": (("logistic", "self"), ("mul", "self", 0)),
    # jnp.clip(x, lo, hi)
    "clamp": (("call_operand", "min"), ("call_operand", "max"),
              ("convert_element_type", 0), ("max", 2, "self"),
              ("convert_element_type", 1), ("min", 4, 3)),
    # jnp.where(c, x, y) is select_n(c, y, x): the false value first
    "where": (("select_n", "condition", "other", "self"),),
    # x.masked_fill(m, v) is jnp.where(m, v, x)
    "masked_fill": (("select_n", "mask", "self", "value"),),
}


def _opname(prim: str) -> str:
    op = _RENAME.get(prim)
    if op is None:
        op = re.sub(r"[^a-z]", "", prim.lower())
    if not op or op in _IR_RESERVED:
        op = "mov"
    return op


def _tile_trips(n) -> int:
    """Per-thread trip count for a tiled (data-parallel) extent of size n."""
    n = int(n) if n else 1
    if n <= 1:
        return 1
    return max(2, min(16, int(round(n ** 0.5))))


def _serial_trips(n) -> int:
    """Trip count for an inherently serial extent (scan/while iterations)."""
    n = int(n) if n else 1
    return max(1, min(12, n))


@dataclass(frozen=True)
class LiftedProgram:
    """A lifted computation: IR program + the trip table the simulator needs."""

    prog: Program
    trips: dict[str, int]
    num_virtual_regs: int


class _Emitter:
    def __init__(self, while_trips: int = 8) -> None:
        self.lines: list[str] = []
        self.trips: dict[str, int] = {}
        self.nreg = 0
        self.npred = 0
        self.nlab = 0
        self.while_trips = while_trips
        self.param_reg = self.fresh()  # base address of the operand space

    def fresh(self) -> int:
        r = self.nreg
        self.nreg += 1
        return r

    def pred(self) -> int:
        p = self.npred
        self.npred += 1
        return p

    def label(self, stem: str) -> str:
        self.nlab += 1
        return f"{stem}{self.nlab}"

    def emit(self, line: str) -> None:
        self.lines.append(line)

    def mov(self, dst: int, src: int | None = None, imm: int = 0) -> int:
        if src is None:
            self.emit(f"mov r{dst}, {imm}")
        else:
            self.emit(f"mov r{dst}, r{src}")
        return dst

    def load(self, addr: int | None = None) -> int:
        d = self.fresh()
        a = self.param_reg if addr is None else addr
        self.emit(f"ld r{d}, [r{a}]")
        return d

    def store(self, val: int, addr: int | None = None) -> None:
        a = self.param_reg if addr is None else addr
        self.emit(f"st r{val}, [r{a}]")

    @contextmanager
    def loop(self, trips: int):
        """Emit a counted loop; the label lands in the sim's trip table."""
        lab = self.label("T")
        ctr, bound = self.fresh(), self.fresh()
        self.mov(bound, imm=max(trips, 1))
        self.mov(ctr, imm=0)
        self.emit(f"{lab}: nop")
        self.trips[lab] = max(trips, 1)
        yield lab
        p = self.pred()
        self.emit(f"add r{ctr}, r{ctr}, 1")
        self.emit(f"set p{p}, r{ctr}, r{bound}")
        self.emit(f"@p{p} bra {lab}")


# -- graph plumbing -----------------------------------------------------------

def _op_name(target) -> str:
    """The aten op's packet name (``mm``), a higher-order op's name (``scan``)."""
    if isinstance(target, torch._ops.OpOverload):
        return target.overloadpacket.__name__
    name = getattr(target, "name", None)
    return name() if callable(name) else getattr(target, "__name__", str(target))


def _shape(node) -> tuple[int, ...]:
    val = node.meta.get("val") if isinstance(node, Node) else None
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def _arg(node: Node, name: str, default=None):
    """An aten op's argument by its schema name."""
    if name in node.kwargs:
        return node.kwargs[name]
    for i, a in enumerate(node.target._schema.arguments):
        if a.name == name:
            return node.args[i] if i < len(node.args) else default
    return default


def _nodes_in(args) -> list[Node]:
    """The graph values among ``args``, lists flattened, in order."""
    out: list[Node] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _nodes_in(a)
        elif isinstance(a, Node):
            out.append(a)
    return out


def _leaves(args) -> list:
    out: list = []
    for a in args:
        out += _leaves(a) if isinstance(a, (list, tuple)) else [a]
    return out


def _placeholders(gm: GraphModule) -> list[Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _outputs(gm: GraphModule) -> list:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return _leaves([out.args[0]])


def _attr(gm: GraphModule, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _reduced_extent(node: Node) -> int:
    """The extent an aten reduction reduces: its ``dim`` of ``self``."""
    shape = _shape(_arg(node, "self"))
    dims = _arg(node, "dim")
    if isinstance(dims, int):
        axes = (dims,)
    elif dims:
        axes = tuple(dims)
    else:  # no dim, or an empty list: every dim
        axes = tuple(range(len(shape)))
    return prod((shape[a] for a in axes), start=1) if shape else 1


class _Lifter:
    def __init__(self, em: _Emitter) -> None:
        self.em = em

    # -- value plumbing ------------------------------------------------------
    def _src(self, env: dict, a) -> int | None:
        if isinstance(a, Node):
            return env[a]
        return None  # Python scalars are immediates: non-register operands

    def _reg_or_mov(self, s: int | None) -> int:
        if s is not None:
            return s
        return self.em.mov(self.em.fresh())

    def _materialize(self, shape) -> int:
        """Bring an operand (kernel parameter / captured const) into registers."""
        if tuple(shape) == ():
            return self.em.mov(self.em.fresh(), imm=1)  # scalar: immediate
        return self.em.load()

    def _bind(self, env: dict, node: Node, regs: list[int]) -> None:
        if isinstance(node.meta.get("val"), (list, tuple)):
            env[node] = list(regs)
        else:
            env[node] = regs[0]

    def _bind_all(self, env: dict, node: Node, d: int) -> None:
        """Every output of ``node`` is ``d`` (one register for the op)."""
        val = node.meta.get("val")
        env[node] = [d] * len(val) if isinstance(val, (list, tuple)) else d

    def _alu(self, prim: str, srcs, movement: bool) -> int:
        """Data movement -> mov; anything else -> one ALU op."""
        em = self.em
        regs = [s for s in srcs if s is not None]
        d = em.fresh()
        if movement or not regs:
            em.mov(d, regs[0] if regs else None)
        else:
            ops = ", ".join(f"r{s}" for s in regs[:3])
            em.emit(f"{_opname(prim)} r{d}, {ops}")
        return d

    # -- graph traversal -----------------------------------------------------
    def _constants(self, gm: GraphModule, env: dict) -> None:
        """Materialize the graph's tensor constants (a jaxpr's constvars)."""
        for n in gm.graph.nodes:
            if n.op == "get_attr":
                val = _attr(gm, n.target)
                if isinstance(val, torch.Tensor):
                    env[n] = self._materialize(val.shape)

    def lift_module(self, gm: GraphModule, env_args: list[int]) -> list[int]:
        """Lift a graph whose placeholders are bound to ``env_args``."""
        env: dict = {}
        self._constants(gm, env)
        for ph, r in zip(_placeholders(gm), env_args):
            env[ph] = r
        self.run(gm, env)
        return [self._reg_or_mov(self._src(env, o)) for o in _outputs(gm)]

    def run(self, gm: GraphModule, env: dict) -> None:
        for node in gm.graph.nodes:
            if node.op == "call_function":
                self.call(gm, env, node)

    def call(self, gm: GraphModule, env: dict, node: Node) -> None:
        em = self.em
        if node.target is operator.getitem:
            env[node] = env[node.args[0]][node.args[1]]
            return
        name = _op_name(node.target)
        if name in _CALLS:
            sub = next(a for a in node.args
                       if isinstance(a, Node) and a.op == "get_attr")
            operands = [a for a in _nodes_in(node.args) if a is not sub]
            outs = self.lift_module(_attr(gm, sub.target),
                                    [self._reg_or_mov(env[a]) for a in operands])
            self._bind(env, node, outs)
            return
        if name == "scan":
            self._scan(gm, env, node)
            return
        if name == "while_loop":
            self._while(gm, env, node)
            return
        if name == "cond":
            self._cond(gm, env, node)
            return
        if name in _COMPOSITES:
            env[node] = self._composite(env, node, _COMPOSITES[name])
            return

        srcs = [env[a] for a in _nodes_in((*node.args, *node.kwargs.values()))]
        if name in _ATEN_DOTS:
            env[node] = self._dot_node(env, node, name)
            return
        if name in _ATEN_REDUCE_OPS:
            env[node] = self._reduce_node(node, srcs[0], _ATEN_REDUCE_OPS[name])
            return
        if name in _ATEN_MEM_READ:
            self._bind_all(env, node, em.load(srcs[0] if srcs else None))
            return
        if name in _ATEN_MEM_WRITE:
            ref = self._reg_or_mov(srcs[0] if srcs else None)
            em.store(srcs[1] if len(srcs) > 1 else ref, ref)
            self._bind_all(env, node, em.mov(em.fresh(), ref))  # the updated aggregate
            return
        self._bind_all(env, node, self._alu(name, srcs, name in _ATEN_DATA_MOVEMENT))

    # -- composite aten ops --------------------------------------------------
    def _composite(self, env: dict, node: Node, steps) -> int:
        """Lower ``node`` as its jnp counterpart's jaxpr primitives."""
        vals: list[int] = []

        def operand(spec):
            if isinstance(spec, int):
                return vals[spec]
            if spec == "imm":
                return None
            return self._src(env, _arg(node, spec))

        for prim, *ops in steps:
            srcs = [operand(o) for o in ops]
            if prim == "call_operand":
                v = self._reg_or_mov(srcs[0])
            elif prim in _PASSTHROUGH and srcs[0] is not None:
                v = srcs[0]
            elif prim in _REDUCE_OPS:
                v = self._reduce_node(node, srcs[0], _REDUCE_OPS[prim])
            else:
                v = self._alu(prim, srcs, prim in _DATA_MOVEMENT)
            vals.append(v)
        return vals[-1]

    # -- structured ops ------------------------------------------------------
    def _dot_node(self, env: dict, node: Node, name: str) -> int:
        """mm/bmm/dot (+ the bias add of addmm/baddbmm) -> `_dot`."""
        bias = None
        if name in ("addmm", "baddbmm"):
            bias, a, b = node.args[:3]
        else:
            a, b = node.args[:2]
        k_extent = _shape(a)[-1]
        out_extent = prod(_shape(node), start=1)
        d = self._dot(k_extent, out_extent, self._src(env, a), self._src(env, b))
        if bias is not None:
            e = self.em.fresh()
            self.em.emit(f"add r{e}, r{d}, r{self._reg_or_mov(self._src(env, bias))}")
            d = e
        return d

    def _dot(self, k_extent: int, out_extent: int, a_src, b_src) -> int:
        """A product -> register-tiled inner loop over the contraction.

        The register tile adapts to the problem: big output tiles with a deep
        contraction get the classic 4x4 blocking (16 accumulators — this is
        what makes real matmul/attention kernels register-sensitive), small
        ones the cheap 2x2.
        """
        em = self.em
        t = 4 if (out_extent >= 1024 and k_extent >= 32) else 2
        a_addr = self._reg_or_mov(a_src)
        b_addr = self._reg_or_mov(b_src)
        acc = [em.fresh() for _ in range(t * t)]
        for c in acc:
            em.mov(c, imm=0)
        with em.loop(_tile_trips(k_extent)):
            a_r = [em.load(a_addr) for _ in range(t)]
            b_r = [em.load(b_addr) for _ in range(t)]
            for i in range(t):
                for j in range(t):
                    c = acc[i * t + j]
                    em.emit(f"mad r{c}, r{a_r[i]}, r{b_r[j]}, r{c}")
        d = em.fresh()
        em.emit(f"add r{d}, r{acc[0]}, r{acc[1]}")
        for c in acc[2:]:
            em.emit(f"add r{d}, r{d}, r{c}")
        return d

    def _reduce_node(self, node: Node, src, op: str) -> int:
        """A reduction of ``node``'s ``dim``; kept dims add the broadcast
        that jnp's ``keepdims=True`` emits."""
        acc = self._reduce(_reduced_extent(node), src, op)
        if _arg(node, "keepdim", False):
            acc = self.em.mov(self.em.fresh(), acc)
        return acc

    def _reduce(self, extent: int, src, op: str) -> int:
        em = self.em
        addr = self._reg_or_mov(src)
        acc = em.mov(em.fresh(), imm=0)
        with em.loop(_tile_trips(extent)):
            t = em.load(addr)
            em.emit(f"{op} r{acc}, r{acc}, r{t}")
        return acc

    def _scan(self, gm: GraphModule, env: dict, node: Node) -> None:
        """``scan(combine, init, xs, additional_inputs)``: the body's
        placeholders are the carries, the xs' slices, then the additional
        inputs (the scan's consts)."""
        em = self.em
        combine, init, xs, additional = node.args[:4]
        body = _attr(gm, combine.target)
        n_carry, n_xs = len(init), len(xs)
        phs = _placeholders(body)

        inner_env: dict = {}
        self._constants(body, inner_env)
        const_regs = [self._reg_or_mov(self._src(env, a)) for a in additional]
        # dedicated loop-carried registers, written back each iteration
        carry_srcs = [self._src(env, c) for c in init]
        carry_regs = [em.mov(em.fresh(), s) if s is not None
                      else em.mov(em.fresh()) for s in carry_srcs]
        for ph, r in zip(phs[n_carry + n_xs:], const_regs):
            inner_env[ph] = r
        for ph, r in zip(phs[:n_carry], carry_regs):
            inner_env[ph] = r
        xs_addr = [self._reg_or_mov(self._src(env, x)) for x in xs]

        length = _shape(xs[0])[0] if xs else 1
        y_regs: list[int] = []
        with em.loop(_serial_trips(length)):
            for ph, a in zip(phs[n_carry:n_carry + n_xs], xs_addr):
                inner_env[ph] = em.load(a)  # per-iteration input slice
            self.run(body, inner_env)
            outs = [self._reg_or_mov(self._src(inner_env, o))
                    for o in _outputs(body)]
            for c, nc in zip(carry_regs, outs[:n_carry]):
                if c != nc:
                    em.mov(c, nc)
            y_regs = outs[n_carry:]
            for y in y_regs:
                em.store(y)  # stacked output writeback
        env[node] = carry_regs + y_regs

    def _while(self, gm: GraphModule, env: dict, node: Node) -> None:
        """``while_loop(cond, body, carried, additional_inputs)``: both
        graphs take the carries, then the additional inputs."""
        em = self.em
        cond_g, body_g, carried, additional = node.args[:4]
        consts = [self._reg_or_mov(self._src(env, a)) for a in additional]
        carry_srcs = [self._src(env, c) for c in carried]
        carry_regs = [em.mov(em.fresh(), s) if s is not None
                      else em.mov(em.fresh()) for s in carry_srcs]
        with em.loop(em.while_trips):
            # the condition's compute happens every iteration too
            self.lift_module(_attr(gm, cond_g.target), carry_regs + consts)
            outs = self.lift_module(_attr(gm, body_g.target), carry_regs + consts)
            for c, nc in zip(carry_regs, outs):
                if c != nc:
                    em.mov(c, nc)
        env[node] = carry_regs

    def _cond(self, gm: GraphModule, env: dict, node: Node) -> None:
        """``cond(pred, true_graph, false_graph, operands)``: the true graph
        is lifted first, as jax's ``branches[1]``."""
        em = self.em
        pred, true_g, false_g, operand_nodes = node.args[:4]
        idx = self._reg_or_mov(self._src(env, pred))
        operands = [self._reg_or_mov(self._src(env, o)) for o in operand_nodes]
        n_out = len(_leaves([node.meta.get("val")]))
        out_regs = [em.fresh() for _ in range(n_out)]
        p = em.pred()
        else_l, join_l = em.label("E"), em.label("J")
        em.emit(f"set p{p}, r{idx}, r{idx}")
        em.emit(f"@!p{p} bra {else_l}")
        t_outs = self.lift_module(_attr(gm, true_g.target), operands)
        for o, t in zip(out_regs, t_outs):
            em.mov(o, t)
        em.emit(f"bra {join_l}")
        em.emit(f"{else_l}: nop")
        f_outs = self.lift_module(_attr(gm, false_g.target), operands)
        for o, f in zip(out_regs, f_outs):
            em.mov(o, f)
        em.emit(f"{join_l}: nop")
        env[node] = out_regs


def lift_graph(gm: GraphModule, name: str = "traced",
               while_trips: int = 8) -> LiftedProgram:
    """Lower an aten graph (from ``make_fx``) into the register IR."""
    em = _Emitter(while_trips=while_trips)
    lifter = _Lifter(em)
    em.emit(f"mov r{em.param_reg}, PARAMS")
    args = [lifter._materialize(_shape(ph)) for ph in _placeholders(gm)]
    outs = lifter.lift_module(gm, args)
    for o in outs:
        em.store(o)
    em.emit("exit")
    prog = parse_asm("\n".join(em.lines), name=name)
    return LiftedProgram(prog=prog, trips=dict(em.trips),
                         num_virtual_regs=em.nreg)


def lift_fn(fn, example_args, name: str = "traced",
            while_trips: int = 8) -> LiftedProgram:
    """Trace ``fn`` at ``example_args`` (CPU or meta tensors: only their
    shapes and dtypes are read) under fake tensors and lift the aten graph.

    A loop to be lifted as one is written with the ``scan`` (or
    ``while_loop``, ``cond``) higher-order op called directly, as
    `repro_torch.frontend.workloads` does: ``torch._higher_order_ops.scan``'s
    front end ``scan()`` captures its body with dynamo, which starts CUDA on
    a machine with a card and recompiles at new shapes with dynamic sizes.

    Callers that want the lift memoized go through
    `repro_torch.frontend.workloads.build_traced_workload`."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def traced(*args):  # positional only: make_fx binds every parameter
        return fn(*args)

    gm = make_fx(traced, tracing_mode="fake")(*example_args)
    return lift_graph(gm, name=name, while_trips=while_trips)
