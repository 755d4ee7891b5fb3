"""Symbolic expression engine with *batched* numpy evaluation.

Mist's key idea #2: derive runtime/memory as symbolic expressions over the
optimization variables once, then evaluate thousands of configurations by
vectorized value substitution instead of re-simulating each one (paper §5.2
reports >1e5 x speedup over per-config simulation; see
benchmarks/tuning_time.py for ours).

The engine is a small DAG (Const / Sym / BinOp / UnOp) with operator
overloading and numpy broadcasting so every symbol may be bound to an array
of candidate values.  ``sympy`` is deliberately avoided in the hot path (too
slow at ~1e6-point batched substitution).

Three evaluation paths exist:

  * ``Expr.evaluate`` — the reference recursive walk with an id-keyed memo
    (kept for tests and as the legacy baseline).
  * ``compile_tape`` — compiles a set of output expressions into a ``Tape``:
    a flat, topologically sorted numpy instruction list that evaluates ALL
    outputs in a single pass.  Nodes are hash-consed (structurally interned)
    at construction, so common subexpressions across outputs are shared
    automatically and each unique node is computed exactly once.  Slots are
    reused once a value's last consumer has run, keeping the working set of
    live candidate-batch arrays small.
  * ``Tape.lower_torch`` — lowers the same instruction list to torch ops on
    a device (the counterpart of the reference's exact jax mode): one
    float64 torch op per instruction, so for tapes of correctly rounded
    ops (``BITEXACT_OPS``) the outputs are bitwise identical to the numpy
    tape on ``cuda`` and on ``cpu``.  Nothing fuses a multiply into an add,
    and constants are float64 tensors on the device (a CPU scalar divisor
    would let the CUDA division multiply by its reciprocal instead).  The
    reference's fused flavour (one ``jax.jit`` program) has no port yet
    (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

import numpy as np

Number = Union[int, float]


class Expr:
    # -- operator overloading -------------------------------------------------
    def __add__(self, o):
        return _bin("add", self, wrap(o))

    def __radd__(self, o):
        return _bin("add", wrap(o), self)

    def __sub__(self, o):
        return _bin("sub", self, wrap(o))

    def __rsub__(self, o):
        return _bin("sub", wrap(o), self)

    def __mul__(self, o):
        return _bin("mul", self, wrap(o))

    def __rmul__(self, o):
        return _bin("mul", wrap(o), self)

    def __truediv__(self, o):
        return _bin("div", self, wrap(o))

    def __rtruediv__(self, o):
        return _bin("div", wrap(o), self)

    def __pow__(self, o):
        return _bin("pow", self, wrap(o))

    def __neg__(self):
        return _bin("mul", Const(-1.0), self)

    # comparisons produce 0/1 indicator expressions
    def __ge__(self, o):
        return _bin("ge", self, wrap(o))

    def __le__(self, o):
        return _bin("le", self, wrap(o))

    def __gt__(self, o):
        return _bin("gt", self, wrap(o))

    def __lt__(self, o):
        return _bin("lt", self, wrap(o))

    def evaluate(self, env: Dict[str, Any], memo=None):
        raise NotImplementedError

    def __call__(self, **env):
        return self.evaluate(env)

    # Hash-consed nodes are constructed through ``__new__``-level intern
    # caches and carry ``__slots__``, so the default pickle protocol (which
    # calls ``__new__`` with no arguments) fails AND would break interning
    # on load.  Each concrete class defines ``__reduce__`` to re-enter its
    # constructor, so ``pickle.loads(pickle.dumps(e)) is e`` holds within a
    # process and spawn-based worker pools receive properly re-interned
    # DAGs (children unpickle first, so the op-cache keys match).


# ---------------------------------------------------------------------------
# Hash-consing: structurally identical nodes are the same object, so shared
# subexpressions across independently-built expressions dedupe (automatic
# CSE for the tape compiler) and id-keyed memos hit maximally.  The caches
# hold strong references, which also keeps id()-based intern keys stable.
# ---------------------------------------------------------------------------

_CONST_CACHE: Dict[Tuple[float, float], "Const"] = {}
_SYM_CACHE: Dict[str, "Sym"] = {}
_OP_CACHE: Dict[Tuple, Expr] = {}


def intern_cache_stats() -> Dict[str, int]:
    return {"const": len(_CONST_CACHE), "sym": len(_SYM_CACHE),
            "op": len(_OP_CACHE)}


def intern_cache_clear() -> None:
    """Drop the intern tables (they hold strong refs to every node built,
    so a long-running process sweeping many distinct models grows them
    monotonically).  Existing Expr objects and compiled Tapes stay fully
    usable — evaluation never consults the caches — only cross-model CSE
    restarts from scratch for nodes built afterwards."""
    _CONST_CACHE.clear()
    _SYM_CACHE.clear()
    _OP_CACHE.clear()


class Const(Expr):
    __slots__ = ("v",)

    def __new__(cls, v: Number):
        v = float(v)
        if v != v:                      # NaN: never interned (NaN != NaN)
            obj = super().__new__(cls)
            obj.v = v
            return obj
        key = (v, math.copysign(1.0, v))
        obj = _CONST_CACHE.get(key)
        if obj is None:
            obj = super().__new__(cls)
            obj.v = v
            _CONST_CACHE[key] = obj
        return obj

    def __init__(self, v: Number):
        pass                            # set in __new__

    def __reduce__(self):
        return (Const, (self.v,))

    def evaluate(self, env, memo=None):
        return self.v

    def __repr__(self):
        return f"{self.v:g}"


class Sym(Expr):
    __slots__ = ("name",)

    def __new__(cls, name: str):
        obj = _SYM_CACHE.get(name)
        if obj is None:
            obj = super().__new__(cls)
            obj.name = name
            _SYM_CACHE[name] = obj
        return obj

    def __init__(self, name: str):
        pass                            # set in __new__

    def __reduce__(self):
        return (Sym, (self.name,))

    def evaluate(self, env, memo=None):
        try:
            return env[self.name]
        except KeyError:
            raise KeyError(f"unbound symbol {self.name!r}; "
                           f"have {sorted(env)}") from None

    def __repr__(self):
        return self.name


_BIN_FNS: Dict[str, Callable] = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": np.divide, "pow": np.power,
    "max": np.maximum, "min": np.minimum,
    "ge": lambda a, b: (np.asarray(a) >= b).astype(np.float64),
    "le": lambda a, b: (np.asarray(a) <= b).astype(np.float64),
    "gt": lambda a, b: (np.asarray(a) > b).astype(np.float64),
    "lt": lambda a, b: (np.asarray(a) < b).astype(np.float64),
}

_UN_FNS: Dict[str, Callable] = {
    "ceil": np.ceil, "floor": np.floor, "sqrt": np.sqrt, "log2": np.log2,
    "abs": np.abs, "rint": np.rint,
}

# reverse fn-identity -> op-name map (instructions store the bound numpy
# callable for the hot loop; backends that need the *semantic* op — the
# torch lowering — recover the name through this)
_FN_NAMES: Dict[int, str] = {id(f): n
                             for d in (_BIN_FNS, _UN_FNS)
                             for n, f in d.items()}

# Ops whose numpy and torch implementations are the same IEEE-754
# correctly-rounded operation, so per-op torch execution in float64 is
# bitwise identical to numpy.  ``pow`` and ``log2`` are NOT: libm and the
# device math libraries approximate them differently, so a tape containing
# them cannot claim the bitwise guarantee — ``Tape.bitexact`` reports this
# and ``Tape.lower_torch`` refuses such tapes rather than serving subtly
# different results.
BITEXACT_OPS = frozenset(
    {"add", "sub", "mul", "div", "max", "min",
     "ge", "le", "gt", "lt", "ceil", "floor", "sqrt", "abs", "rint"})
# ... except on torch's CPU, whose float64 sqrt is not correctly rounded
# (torch 2.13: sqrt(2.0) one ulp below numpy's, which is; CUDA's double
# sqrt is IEEE round-to-nearest, and chip_smoke.py checks it on the card)
TORCH_CPU_INEXACT_OPS = frozenset({"sqrt"})


def _torch_fn_tables(torch):
    """torch twins of ``_BIN_FNS`` / ``_UN_FNS`` (float64 in, float64 out;
    comparisons cast their 0/1 result to float64, ``rint`` is
    ``torch.round``: half to even, as ``np.rint``).

    ``max``/``min`` are selects, not ``torch.maximum``/``minimum``: on
    equal operands (+0 against -0) numpy returns the second one, on every
    path (its x86 SIMD max/min), while torch's answer depends on whether
    an element falls in a vector body or a scalar tail.  A NaN in either
    operand gives NaN, as in numpy."""
    f64 = torch.float64

    def cmp(op):
        def f(a, b):
            return op(a, b).to(f64)
        return f

    def select(op):
        def f(a, b):
            return torch.where(op(a, b) | torch.isnan(a), a, b)
        return f
    tbin = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div, "max": select(torch.gt),
            "min": select(torch.lt),
            "ge": cmp(torch.ge), "le": cmp(torch.le),
            "gt": cmp(torch.gt), "lt": cmp(torch.lt)}
    tun = {"ceil": torch.ceil, "floor": torch.floor, "sqrt": torch.sqrt,
           "abs": torch.abs, "rint": torch.round}
    return tbin, tun


class BinOp(Expr):
    __slots__ = ("op", "a", "b")

    def __new__(cls, op: str, a: Expr, b: Expr):
        key = ("b", op, id(a), id(b), a, b)
        obj = _OP_CACHE.get(key)
        if obj is None:
            obj = super().__new__(cls)
            obj.op, obj.a, obj.b = op, a, b
            _OP_CACHE[key] = obj
        return obj

    def __init__(self, op: str, a: Expr, b: Expr):
        pass                            # set in __new__

    def __reduce__(self):
        return (BinOp, (self.op, self.a, self.b))

    def evaluate(self, env, memo=None):
        memo = {} if memo is None else memo
        key = id(self)
        if key in memo:
            return memo[key]
        out = _BIN_FNS[self.op](self.a.evaluate(env, memo),
                                self.b.evaluate(env, memo))
        memo[key] = out
        return out

    def __repr__(self):
        return f"({self.a!r} {self.op} {self.b!r})"


class UnOp(Expr):
    __slots__ = ("op", "a")

    def __new__(cls, op: str, a: Expr):
        key = ("u", op, id(a), a)
        obj = _OP_CACHE.get(key)
        if obj is None:
            obj = super().__new__(cls)
            obj.op, obj.a = op, a
            _OP_CACHE[key] = obj
        return obj

    def __init__(self, op: str, a: Expr):
        pass                            # set in __new__

    def __reduce__(self):
        return (UnOp, (self.op, self.a))

    def evaluate(self, env, memo=None):
        memo = {} if memo is None else memo
        key = id(self)
        if key in memo:
            return memo[key]
        out = _UN_FNS[self.op](self.a.evaluate(env, memo))
        memo[key] = out
        return out

    def __repr__(self):
        return f"{self.op}({self.a!r})"


def wrap(x) -> Expr:
    return x if isinstance(x, Expr) else Const(x)


def _bin(op, a, b) -> Expr:
    # light constant folding
    if isinstance(a, Const) and isinstance(b, Const):
        return Const(_BIN_FNS[op](a.v, b.v))
    if op == "add":
        if isinstance(a, Const) and a.v == 0:
            return b
        if isinstance(b, Const) and b.v == 0:
            return a
    if op == "mul":
        if isinstance(a, Const) and a.v == 1:
            return b
        if isinstance(b, Const) and b.v == 1:
            return a
        if (isinstance(a, Const) and a.v == 0) or \
                (isinstance(b, Const) and b.v == 0):
            return Const(0.0)
    return BinOp(op, a, b)


def smax(a, b) -> Expr:
    return _bin("max", wrap(a), wrap(b))


def smin(a, b) -> Expr:
    return _bin("min", wrap(a), wrap(b))


def ceil(a) -> Expr:
    return UnOp("ceil", wrap(a))


def ceil_div(a, b) -> Expr:
    return ceil(wrap(a) / wrap(b))


def rint(a) -> Expr:
    """Round half to even — the same correctly-rounded operation as
    Python ``round()`` / ``np.rint`` / ``jnp.round`` on float64, so the
    integer split points the runtime computes with ``round()`` are
    reproducible symbolically, bit for bit."""
    return UnOp("rint", wrap(a))


def where(cond: Expr, a, b) -> Expr:
    """cond is a 0/1 indicator expression."""
    c = wrap(cond)
    return c * wrap(a) + (Const(1.0) - c) * wrap(b)


def sum_exprs(xs) -> Expr:
    out: Expr = Const(0.0)
    for x in xs:
        out = out + wrap(x)
    return out


# ---------------------------------------------------------------------------
# Tape compilation: one topological sort of the shared output DAG into a flat
# instruction list; evaluation is a single linear pass with slot reuse.
# ---------------------------------------------------------------------------


class TapeScratch:
    """Reusable per-instruction output buffers for ``Tape.run``.

    The first run records each non-output instruction's result array as
    that instruction's buffer; later runs write into it via the ufunc
    ``out=`` argument, eliminating one allocation per instruction in the
    steady state of a big sweep.  When the batch shape changes, the ufunc
    rejects the stale buffer and a fresh result array is adopted instead
    (self-resizing).  Only safe because intermediate values never escape
    ``run`` — output slots always get fresh arrays."""

    __slots__ = ("bufs",)

    def __init__(self, tape: "Tape"):
        self.bufs: List[Any] = [None] * len(tape.instrs)


class Tape:
    """Compiled evaluation plan for a set of named output expressions.

    ``run(env)`` returns {name: value} where each value is whatever numpy
    broadcasting of the bound symbols yields (scalar or ndarray) — bitwise
    identical to ``Expr.evaluate`` on the same env, since each unique DAG
    node executes the same numpy op on the same inputs exactly once.
    ``run(env, scratch=tape.make_scratch())`` additionally reuses
    intermediate buffers across runs (ufunc ``out=``), which cuts
    allocation traffic in tight sweep loops; results stay bitwise
    identical (same ufunc, same operands, preallocated destination).
    """

    __slots__ = ("instrs", "n_slots", "sym_loads", "const_loads",
                 "out_slots", "ops", "bitexact", "_reusable",
                 "_torch_cache")

    def __init__(self, instrs, n_slots, sym_loads, const_loads, out_slots):
        self.instrs = instrs            # [(fn, dst, a, b)]; b < 0 => unary
        self.n_slots = n_slots
        self.sym_loads = sym_loads      # [(name, slot)]
        self.const_loads = const_loads  # [(slot, value)]
        self.out_slots = out_slots      # {name: slot}
        self.ops = [_FN_NAMES[id(fn)] for fn, _, _, _ in instrs]
        # whether every instruction is correctly rounded in both numpy and
        # torch (BITEXACT_OPS), i.e. whether torch execution in float64 is
        # bitwise identical to run(); False for pow/log2 tapes.
        self.bitexact = all(op in BITEXACT_OPS for op in self.ops)
        self._torch_cache: Dict[Any, Callable] = {}
        # instructions whose result may be buffer-reused: real ufuncs (the
        # comparison lambdas aren't) writing a non-output slot at this
        # program point (output values escape run() and must stay fresh).
        out_writers = set()
        final_writer: Dict[int, int] = {}
        for i, (_, dst, _, _) in enumerate(instrs):
            final_writer[dst] = i
        for s in out_slots.values():
            if s in final_writer:
                out_writers.add(final_writer[s])
        self._reusable = [
            isinstance(fn, np.ufunc) and i not in out_writers
            for i, (fn, _, _, _) in enumerate(instrs)]

    def __len__(self):
        return len(self.instrs)

    def make_scratch(self) -> TapeScratch:
        return TapeScratch(self)

    # -- torch lowering -----------------------------------------------------
    def lower_torch(self, device) -> Callable:
        """Lower the instruction list to torch on ``device``; returns
        ``f(env) -> outputs``.

        Each instruction runs as one float64 torch op on device tensors, in
        the tape's order, so for tapes whose ops are all correctly rounded
        (``bitexact``; everything but ``pow``/``log2``) the outputs are
        bitwise identical to ``Tape.run`` — the guarantee the tuner's
        plan identity rests on.  Tapes with ``pow``/``log2`` raise, and so
        do tapes with ``sqrt`` on the CPU (``TORCH_CPU_INEXACT_OPS``; the
        cost model's tapes have none).
        Inputs are numpy arrays or scalars (copied to the device as
        float64); outputs are float64 tensors on ``device`` (``.cpu()`` and
        ``.numpy()`` them to re-enter numpy code).  The callable is cached
        per device on the tape."""
        import torch
        if not self.bitexact:
            bad = sorted({op for op in self.ops if op not in BITEXACT_OPS})
            raise ValueError(f"tape has ops {bad} that are not correctly "
                             "rounded in both numpy and torch; the torch "
                             "backend would not be bitwise equal to numpy")
        dev = torch.device(device)
        if dev.type == "cpu" and TORCH_CPU_INEXACT_OPS.intersection(
                self.ops):
            raise ValueError("tape has sqrt, which torch does not round "
                             "correctly on the CPU; the torch backend "
                             "would not be bitwise equal to numpy there")
        fn = self._torch_cache.get(dev)
        if fn is None:
            fn = self._build_torch(torch, dev)
            self._torch_cache[dev] = fn
        return fn

    def _build_torch(self, torch, dev) -> Callable:
        tbin, tun = _torch_fn_tables(torch)
        tinstrs = [(tun[op] if b < 0 else tbin[op], dst, a, b)
                   for op, (_, dst, a, b) in zip(self.ops, self.instrs)]
        consts = [(slot, torch.tensor(float(v), dtype=torch.float64,
                                      device=dev))
                  for slot, v in self.const_loads]
        sym_loads, out_slots = self.sym_loads, self.out_slots
        n_slots = self.n_slots

        def run(env: Mapping[str, Any]) -> Dict[str, Any]:
            slots: List[Any] = [None] * n_slots
            for slot, v in consts:
                slots[slot] = v
            for name, slot in sym_loads:
                try:
                    v = env[name]
                except KeyError:
                    raise KeyError(f"unbound symbol {name!r}; "
                                   f"have {sorted(env)}") from None
                slots[slot] = torch.as_tensor(
                    np.asarray(v, np.float64)).to(dev)
            for f, dst, a, b in tinstrs:
                slots[dst] = f(slots[a]) if b < 0 else f(slots[a], slots[b])
            return {name: slots[slot] for name, slot in out_slots.items()}

        return run

    def run(self, env: Mapping[str, Any],
            scratch: "TapeScratch" = None) -> Dict[str, Any]:
        slots: List[Any] = [None] * self.n_slots
        for slot, v in self.const_loads:
            slots[slot] = v
        for name, slot in self.sym_loads:
            try:
                slots[slot] = env[name]
            except KeyError:
                raise KeyError(f"unbound symbol {name!r}; "
                               f"have {sorted(env)}") from None
        if scratch is None:
            for fn, dst, a, b in self.instrs:
                slots[dst] = fn(slots[a]) if b < 0 else fn(slots[a], slots[b])
        else:
            bufs = scratch.bufs
            reusable = self._reusable
            nd = np.ndarray
            for i, (fn, dst, a, b) in enumerate(self.instrs):
                va = slots[a]
                buf = bufs[i]
                if b < 0:
                    # ``out=`` only when the result provably fills the
                    # buffer exactly — a scalar operand would silently
                    # broadcast into a stale larger buffer otherwise.
                    if buf is not None and type(va) is nd \
                            and va.shape == buf.shape:
                        r = fn(va, out=buf)
                    else:
                        if buf is not None:
                            bufs[i] = None      # batch shape changed
                        r = fn(va)
                else:
                    vb = slots[b]
                    if buf is not None:
                        sa = va.shape if type(va) is nd else ()
                        sb = vb.shape if type(vb) is nd else ()
                        if (sa == buf.shape and sb in ((), buf.shape)) \
                                or (sb == buf.shape and sa == ()):
                            r = fn(va, vb, out=buf)
                        else:
                            bufs[i] = None
                            r = fn(va, vb)
                    else:
                        r = fn(va, vb)
                if bufs[i] is None and reusable[i] \
                        and type(r) is nd and r.ndim:
                    bufs[i] = r
                slots[dst] = r
        return {name: slots[slot] for name, slot in self.out_slots.items()}


def _children(node: Expr) -> Tuple[Expr, ...]:
    if isinstance(node, BinOp):
        return (node.a, node.b)
    if isinstance(node, UnOp):
        return (node.a,)
    return ()


def compile_tape(outputs: Mapping[str, Expr]) -> Tape:
    """Compile named output expressions into a single shared Tape."""
    # -- one topological (post-) order over the union DAG, deduped by id ----
    order: List[Expr] = []
    visited: set = set()
    for root in outputs.values():
        if id(root) in visited:
            continue
        stack: List[Tuple[Expr, bool]] = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in visited:
                continue
            visited.add(id(node))
            stack.append((node, True))
            for ch in _children(node):
                if id(ch) not in visited:
                    stack.append((ch, False))

    # -- consumer counts for slot-liveness ----------------------------------
    uses: Dict[int, int] = {}
    for node in order:
        for ch in _children(node):
            uses[id(ch)] = uses.get(id(ch), 0) + 1
    pinned = {id(e) for e in outputs.values()}   # outputs live forever

    slot_of: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    def release(node: Expr):
        nid = id(node)
        uses[nid] -= 1
        if uses[nid] == 0 and nid not in pinned:
            free.append(slot_of[nid])

    instrs: List[Tuple[Callable, int, int, int]] = []
    sym_loads: List[Tuple[str, int]] = []
    const_loads: List[Tuple[int, Any]] = []
    # Leaves first: their loads are hoisted to the start of run(), so they
    # must never be placed into a slot freed mid-stream (an instruction
    # writing there earlier in the pass would clobber the hoisted load).
    # Dead leaf slots CAN later be reused as instruction destinations.
    for node in order:
        if isinstance(node, Const):
            s = alloc()
            const_loads.append((s, node.v))
            slot_of[id(node)] = s
        elif isinstance(node, Sym):
            s = alloc()
            sym_loads.append((node.name, s))
            slot_of[id(node)] = s
    for node in order:
        nid = id(node)
        if isinstance(node, (Const, Sym)):
            continue
        if isinstance(node, BinOp):
            a, b = slot_of[id(node.a)], slot_of[id(node.b)]
            release(node.a)
            release(node.b)
            s = alloc()                 # may legally reuse a child's slot:
            instrs.append((_BIN_FNS[node.op], s, a, b))  # read-before-write
        elif isinstance(node, UnOp):
            a = slot_of[id(node.a)]
            release(node.a)
            s = alloc()
            instrs.append((_UN_FNS[node.op], s, a, -1))
        else:
            raise TypeError(f"cannot compile node {node!r}")
        slot_of[nid] = s

    out_slots = {name: slot_of[id(e)] for name, e in outputs.items()}
    return Tape(instrs, n_slots, sym_loads, const_loads, out_slots)
