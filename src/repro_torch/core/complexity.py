"""Cyclomatic and NPath complexity of lock operations (paper Table 1).

The paper reports (lock / unlock): Ticket 2/1 & 2/1, QSpinLock 4320/1 & 18/1,
TWA 28/1 & 6/1 (NPath & cyclomatic respectively).  We compute the same
control-flow-graph-derived measures for *our* implementations from their AST,
so the benchmark reproduces Table 1's methodology rather than its literals
(Python encodes the same control flow slightly differently than C).

Cyclomatic complexity = #decisions + 1, decisions = if/while/for/boolop-edges/
assert/ternary/comprehension-ifs.  NPath = product over a statement sequence of
per-statement path counts (Nejmeh 1988), with while/for counted as (body + 1)
paths and short-circuit operators multiplying.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass


def _decision_count(node: ast.AST) -> int:
    count = 0
    for n in ast.walk(node):
        if isinstance(n, (ast.If, ast.While, ast.For, ast.IfExp, ast.Assert)):
            count += 1
        elif isinstance(n, ast.BoolOp):
            count += len(n.values) - 1
        elif isinstance(n, ast.comprehension):
            count += 1 + len(n.ifs)
    return count


def cyclomatic(func) -> int:
    tree = ast.parse(textwrap.dedent(inspect.getsource(func)))
    return _decision_count(tree) + 1


def _npath_stmts(stmts: list[ast.stmt]) -> int:
    total = 1
    for s in stmts:
        total *= _npath_stmt(s)
    return total


def _npath_expr(e: ast.AST | None) -> int:
    if e is None:
        return 1
    extra = 0
    for n in ast.walk(e):
        if isinstance(n, ast.BoolOp):
            extra += len(n.values) - 1
        elif isinstance(n, ast.IfExp):
            extra += 1
    return 1 + extra


def _npath_stmt(s: ast.stmt) -> int:
    if isinstance(s, ast.If):
        body = _npath_stmts(s.body)
        orelse = _npath_stmts(s.orelse) if s.orelse else 1
        return _npath_expr(s.test) - 1 + body + orelse
    if isinstance(s, (ast.While, ast.For)):
        test = s.test if isinstance(s, ast.While) else None
        return _npath_expr(test) - 1 + _npath_stmts(s.body) + 1
    if isinstance(s, (ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
                      ast.Return, ast.Assert, ast.Raise)):
        val = getattr(s, "value", None) or getattr(s, "test", None)
        return _npath_expr(val)
    if isinstance(s, ast.Try):
        return _npath_stmts(s.body) + sum(_npath_stmts(h.body) for h in s.handlers)
    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return 1
    return 1


def npath(func) -> int:
    tree = ast.parse(textwrap.dedent(inspect.getsource(func)))
    fn = tree.body[0]
    assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    return _npath_stmts(fn.body)


@dataclass
class ComplexityRow:
    algorithm: str
    npath_lock: int
    npath_unlock: int
    cyclomatic_lock: int
    cyclomatic_unlock: int


def measure(lock_cls, include_helpers: tuple = ()) -> ComplexityRow:
    """Complexity of a lock class's acquire/release (+inlined private helpers,
    mirroring the paper's treatment of the top-level method + trivial helpers)."""
    np_l, cc_l = npath(lock_cls.acquire), cyclomatic(lock_cls.acquire)
    for helper in include_helpers:
        np_l *= max(1, npath(helper))
        cc_l += cyclomatic(helper) - 1
    return ComplexityRow(
        algorithm=getattr(lock_cls, "name", lock_cls.__name__),
        npath_lock=np_l,
        npath_unlock=npath(lock_cls.release),
        cyclomatic_lock=cc_l,
        cyclomatic_unlock=cyclomatic(lock_cls.release),
    )


def table1() -> list[ComplexityRow]:
    from .mcs import MCSLock
    from .ticket import TicketLock
    from .twa import TWALock
    from .variants import TWAStagedLock

    return [
        measure(TicketLock),
        measure(TWALock, include_helpers=(TWALock._long_term_wait,)),
        measure(TWAStagedLock,
                include_helpers=(TWAStagedLock._long_term_wait,)),
        measure(MCSLock),
    ]
