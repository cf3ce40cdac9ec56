"""Arbitrary boolean-circuit evaluation with batched scheduling.

A netlist (list of gates over numbered wires) is compiled into a level-
ordered, gate-type-grouped execution plan — by the native C++ scheduler
(csrc/circuit_scheduler.cpp) when built, else a pure-Python fallback with
identical semantics (tests assert parity). Each plan group then runs as ONE
batched bootstrap on the device: the reference evaluates its 80-gate adder
with 80 sequential bootstraps (examples/add_two_numbers.rs:60-97); here the
same netlist runs in ~2*W plan groups whose gathers/scatters are static
index maps (pure data movement under jit).

This is the server-runtime seam: circuit compilation and scheduling are
host/native work, gate execution stays on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import gates as G
from ..key import CloudKey

#: op name -> (code, arity). Codes must match csrc/circuit_scheduler.cpp.
OPS = {
    "nand": (0, 2), "and": (1, 2), "or": (2, 2), "nor": (3, 2),
    "xor": (4, 2), "xnor": (5, 2), "and_ny": (6, 2), "and_yn": (7, 2),
    "or_ny": (8, 2), "or_yn": (9, 2), "not": (10, 1), "mux": (11, 3),
    "copy": (12, 1),
}
_CODE_TO_NAME = {v[0]: k for k, v in OPS.items()}

_GATE_FNS = {
    "nand": G.nand, "and": G.and_, "or": G.or_, "nor": G.nor,
    "xor": G.xor, "xnor": G.xnor, "and_ny": G.and_ny, "and_yn": G.and_yn,
    "or_ny": G.or_ny, "or_yn": G.or_yn,
}


@dataclasses.dataclass(frozen=True)
class Gate:
    op: str
    a: int
    out: int
    b: Optional[int] = None
    c: Optional[int] = None  # mux: a=select, b=then, c=else


@dataclasses.dataclass
class Circuit:
    """n_inputs input wires [0, n_inputs); each gate writes a fresh wire."""

    n_inputs: int
    gates: list[Gate] = dataclasses.field(default_factory=list)

    @property
    def n_wires(self) -> int:
        m = self.n_inputs - 1
        for g in self.gates:
            m = max(m, g.out)
        return m + 1

    def add(self, op: str, a: int, b: int | None = None, c: int | None = None,
            out: int | None = None) -> int:
        """Append a gate; returns its output wire (fresh by default)."""
        if out is None:
            out = self.n_wires
        self.gates.append(Gate(op=op, a=a, b=b, c=c, out=out))
        return out

    def _arrays(self):
        n = len(self.gates)
        op = np.zeros(n, np.int32)
        a = np.zeros(n, np.int32)
        b = np.zeros(n, np.int32)
        c = np.zeros(n, np.int32)
        outw = np.zeros(n, np.int32)
        for i, g in enumerate(self.gates):
            code, arity = OPS[g.op]
            op[i], a[i], outw[i] = code, g.a, g.out
            b[i] = -1 if g.b is None else g.b
            c[i] = -1 if g.c is None else g.c
            if arity >= 2 and g.b is None or arity == 3 and g.c is None:
                raise ValueError(f"gate {i} ({g.op}): missing operand")
        return op, a, b, c, outw


@dataclasses.dataclass(frozen=True)
class Plan:
    """order: gate indices sorted by (level, op); groups: [(start, end, op
    name, level)] — each group is one batched device call."""

    levels: np.ndarray  # [n_gates]
    order: np.ndarray  # [n_gates]
    groups: list[tuple[int, int, str, int]]
    n_levels: int


def plan_python(circuit: Circuit) -> Plan:
    """Pure-Python scheduler, semantics-identical to the native one."""
    op, a, b, c, outw = circuit._arrays()
    n_gates, n_wires, n_inputs = len(op), circuit.n_wires, circuit.n_inputs

    producer = {}
    for g in range(n_gates):
        w = int(outw[g])
        if w < n_inputs or w in producer:
            raise ValueError(f"invalid output wire {w} (gate {g})")
        producer[w] = g

    def inputs_of(g):
        code = int(op[g])
        ins = [int(a[g])]
        if code <= 9 or code == 11:
            ins.append(int(b[g]))
        if code == 11:
            ins.append(int(c[g]))
        return ins

    indeg = np.zeros(n_gates, np.int32)
    consumers: dict[int, list[int]] = {}
    for g in range(n_gates):
        for w in inputs_of(g):
            if w < 0 or w >= n_wires:
                raise ValueError(f"wire {w} out of range (gate {g})")
            if w >= n_inputs:
                if w not in producer:
                    raise ValueError(f"wire {w} never written (gate {g})")
                indeg[g] += 1
                consumers.setdefault(w, []).append(g)

    levels = np.zeros(n_gates, np.int32)
    ready = [g for g in range(n_gates) if indeg[g] == 0]
    done = 0
    while ready:
        nxt = []
        for g in ready:
            done += 1
            for cg in consumers.get(int(outw[g]), []):
                levels[cg] = max(levels[cg], levels[g] + 1)
                indeg[cg] -= 1
                if indeg[cg] == 0:
                    nxt.append(cg)
        ready = nxt
    if done != n_gates:
        raise ValueError("dependency cycle in circuit")

    order = sorted(range(n_gates), key=lambda g: (int(levels[g]), int(op[g])))
    groups = []
    for i, g in enumerate(order):
        key = (int(levels[g]), int(op[g]))
        if not groups or (groups[-1][3], OPS[groups[-1][2]][0]) != key:
            if groups:
                groups[-1] = (groups[-1][0], i, groups[-1][2], groups[-1][3])
            groups.append((i, -1, _CODE_TO_NAME[int(op[g])], int(levels[g])))
    if groups:
        groups[-1] = (groups[-1][0], n_gates, groups[-1][2], groups[-1][3])
    n_levels = int(levels.max()) + 1 if n_gates else 0
    return Plan(levels=levels, order=np.asarray(order, np.int32),
                groups=groups, n_levels=n_levels)


def plan_native(circuit: Circuit) -> Plan:
    """Schedule via the C++ planner (csrc/circuit_scheduler.cpp)."""
    from .. import native

    lib = native._load()
    op, a, b, c, outw = circuit._arrays()
    n = len(op)
    n_wires, n_inputs = circuit.n_wires, circuit.n_inputs
    levels = np.zeros(n, np.int32)
    order = np.zeros(n, np.int32)
    max_groups = 13 * (n + 1)
    gs = np.zeros(max_groups, np.int32)
    go = np.zeros(max_groups, np.int32)
    gl = np.zeros(max_groups, np.int32)

    i32p = ctypes.POINTER(ctypes.c_int32)

    def p(x):
        return x.ctypes.data_as(i32p)

    ng = lib.circuit_plan(p(op), p(a), p(b), p(c), p(outw),
                          ctypes.c_int32(n), ctypes.c_int32(n_wires),
                          ctypes.c_int32(n_inputs), p(levels), p(order),
                          p(gs), p(go), p(gl), ctypes.c_int32(max_groups))
    if ng < 0:
        raise ValueError(f"circuit_plan failed: code {ng}")
    groups = []
    for i in range(ng):
        start = int(gs[i])
        end = int(gs[i + 1]) if i + 1 < ng else n
        groups.append((start, end, _CODE_TO_NAME[int(go[i])], int(gl[i])))
    n_levels = int(levels.max()) + 1 if n else 0
    return Plan(levels=levels, order=order, groups=groups, n_levels=n_levels)


def plan(circuit: Circuit) -> Plan:
    from .. import native

    return (plan_native if native.available() else plan_python)(circuit)


def evaluate(
    circuit: Circuit, inputs: jax.Array, ck: CloudKey,
    the_plan: Plan | None = None,
) -> jax.Array:
    """Run the circuit over encrypted inputs.

    inputs: uint32 [n_inputs, n0+1] (one LWE ciphertext per input wire).
    Returns uint32 [n_wires, n0+1] — every wire's ciphertext (slice the
    outputs you need). Each plan group is one batched gate over statically
    gathered rows; NOT/COPY are bootstrap-free.
    """
    pl_ = the_plan if the_plan is not None else plan(circuit)
    op_arr, a_arr, b_arr, c_arr, out_arr = circuit._arrays()

    wires = jnp.zeros((circuit.n_wires, inputs.shape[-1]), jnp.uint32)
    wires = wires.at[: circuit.n_inputs].set(inputs)

    for start, end, opname, _level in pl_.groups:
        idx = pl_.order[start:end]
        ai = a_arr[idx]
        outi = out_arr[idx]
        av = wires[ai]
        if opname == "not":
            res = G.not_(av)
        elif opname == "copy":
            res = G.copy(av)
        elif opname == "mux":
            res = G.mux(av, wires[b_arr[idx]], wires[c_arr[idx]], ck)
        else:
            res = _GATE_FNS[opname](av, wires[b_arr[idx]], ck)
        wires = wires.at[outi].set(res)
    return wires


def compile_circuit(circuit: Circuit, the_plan: Plan | None = None):
    """Compile the whole execution plan into ONE jitted device program.

    `evaluate` dispatches each plan group separately (~100 host round trips
    for the 32-bit adder). The returned `run(inputs, ck)` closes over the static
    plan (gather/scatter indices bake in as constants) and jits the entire
    group sequence, so a full circuit evaluation is a single dispatch.
    Keys stay jit ARGUMENTS (closure-captured CloudKeys would embed into
    the program as constants).
    Compile cost scales with gate count; the executable is cached per
    (circuit identity, key shapes) by jax's jit cache.
    """
    pl_ = the_plan if the_plan is not None else plan(circuit)
    op_arr, a_arr, b_arr, c_arr, out_arr = circuit._arrays()
    groups = [
        (int(s), int(e), opname,
         tuple(int(x) for x in pl_.order[s:e]))
        for s, e, opname, _lvl in pl_.groups
    ]

    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("impl",))
    def _run(inputs, ck, impl="auto"):
        del impl  # jit-cache key for config.step_impl (CLAUDE.md invariant)
        wires = jnp.zeros((circuit.n_wires, inputs.shape[-1]), jnp.uint32)
        wires = wires.at[: circuit.n_inputs].set(inputs)
        for _s, _e, opname, idx in groups:
            idx = np.asarray(idx, np.int32)
            ai = a_arr[idx]
            av = wires[ai]
            if opname == "not":
                res = G.not_(av)
            elif opname == "copy":
                res = G.copy(av)
            elif opname == "mux":
                res = G.mux(av, wires[b_arr[idx]], wires[c_arr[idx]], ck)
            else:
                res = _GATE_FNS[opname](av, wires[b_arr[idx]], ck)
            wires = wires.at[out_arr[idx]].set(res)
        return wires

    from ..config import config

    def run(inputs: jax.Array, ck: CloudKey) -> jax.Array:
        return _run(inputs, ck, config.step_impl)

    return run


def ripple_carry_adder(width: int) -> tuple[Circuit, list[int], list[int], list[int]]:
    """The reference's adder netlist (examples/add_two_numbers.rs:60-97):
    full adders from xor/and/or, carry-chained. Returns
    (circuit, a_wires, b_wires, sum_wires); sequential depth ~3*W, but the
    scheduler still batches the independent first-level xor/and pairs."""
    ckt = Circuit(n_inputs=2 * width)
    a_w = list(range(width))
    b_w = list(range(width, 2 * width))
    sums = []
    carry = None
    for i in range(width):
        axb = ckt.add("xor", a_w[i], b_w[i])
        aab = ckt.add("and", a_w[i], b_w[i])
        if carry is None:
            sums.append(ckt.add("copy", axb))
            carry = aab
        else:
            sums.append(ckt.add("xor", axb, carry))
            t = ckt.add("and", axb, carry)
            carry = ckt.add("or", aab, t)
    return ckt, a_w, b_w, sums
