"""A small SQL front end lowering to the plan IR.

Reproduces `vss_tpu/query/sql.py`.

The reference is driven entirely through SQL (SURVEY §1 L0); this module
provides the equivalent surface for the statements its test-suite uses:

    CREATE TABLE t (id BIGINT, vec FLOAT[3]);
    INSERT INTO t VALUES (1, [1.0, 2.0, 3.0]), ...;
    CREATE INDEX idx ON t USING HNSW (vec) WITH (metric = 'l2sq', m = 16);
    SELECT id FROM t ORDER BY array_distance(vec, [...]) LIMIT 3;
    SELECT min_by(id, array_distance(vec, [...]), 3) FROM t;
    SELECT * FROM pragma_hnsw_index_info();
    PRAGMA hnsw_compact_index('idx');
    SET hnsw_ef_search = 128;
    EXPLAIN SELECT ...;
    DELETE FROM t WHERE ...;  UPDATE t SET ... WHERE ...;
    DROP TABLE t;  DROP INDEX idx;  CHECKPOINT 'path';

Recursive-descent parser; expressions lower to `vss_tpu_torch.query.ir`.
Option validation is delegated to `Database.create_hnsw_index`, with
value-type checks here mirroring the reference binder errors
(`hnsw_index_plan.cpp:33-80`).

One addition to the JAX package's grammar: the modulo operator `%`
(`DELETE FROM t WHERE id % 5 = 0`), with DuckDB's sign rule.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np

from vss_tpu_torch.query.ir import (
    BinOp,
    ColumnRef,
    Const,
    Expr,
    Filter,
    Func,
    Limit,
    MinByAgg,
    Not,
    PlanNode,
    Projection,
    Scan,
    TopK,
    format_plan,
)
from vss_tpu_torch.query.table import BinderError, Database

__all__ = ["execute_sql", "parse_statement"]

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<num>-?\d+\.\d*(?:[eE][+-]?\d+)?|-?\.\d+(?:[eE][+-]?\d+)?|-?\d+(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op>::|<=>|<->|<\#>|<=|>=|!=|==|\(|\)|\[|\]|,|;|\*|%|=|<|>|\+|-|/|\.)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise BinderError(f"cannot tokenize SQL at: {text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("num", "str", "id", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0

    # -------------------------------------------------------- token utils
    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        kind, v = self.peek()
        if kind == "id" and v.upper() in kws:
            self.next()
            return v.upper()
        return None

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise BinderError(f"expected {kw} near {self.peek()[1]!r}")

    def accept_op(self, op: str) -> bool:
        kind, v = self.peek()
        if kind == "op" and v == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise BinderError(f"expected '{op}' near {self.peek()[1]!r}")

    def ident(self) -> str:
        kind, v = self.next()
        if kind != "id":
            raise BinderError(f"expected identifier, got {v!r}")
        return v

    # -------------------------------------------------------- expressions
    def expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        e = self._and()
        while self.accept_kw("OR"):
            e = BinOp("or", e, self._and())
        return e

    def _and(self) -> Expr:
        e = self._not()
        while self.accept_kw("AND"):
            e = BinOp("and", e, self._not())
        return e

    def _not(self) -> Expr:
        if self.accept_kw("NOT"):
            return Not(self._not())
        return self._cmp()

    def _cmp(self) -> Expr:
        e = self._add()
        kind, v = self.peek()
        if kind == "op" and v in ("<", "<=", ">", ">=", "=", "==", "!="):
            self.next()
            return BinOp(v, e, self._add())
        # vector distance operator aliases: a <-> b, a <=> b, a <#> b
        if kind == "op" and v in ("<->", "<=>", "<#>"):
            self.next()
            return Func(v, [e, self._add()])
        if self.accept_kw("BETWEEN"):
            lo = self._add()
            self.expect_kw("AND")
            hi = self._add()
            return BinOp("and", BinOp(">=", e, lo), BinOp("<=", e, hi))
        return e

    def _add(self) -> Expr:
        e = self._mul()
        while True:
            kind, v = self.peek()
            if kind == "op" and v in ("+", "-"):
                self.next()
                e = BinOp(v, e, self._mul())
            else:
                return e

    def _mul(self) -> Expr:
        e = self._primary()
        while True:
            kind, v = self.peek()
            if kind == "op" and v in ("*", "/", "%"):
                self.next()
                e = BinOp(v, e, self._primary())
            else:
                return e

    def _primary(self) -> Expr:
        return self._postfix(self._primary_base())

    def _postfix(self, e: Expr) -> Expr:
        """`expr::TYPE[n]` cast chains (hnsw_basic.test:22 etc.). Casts of
        numeric constants fold at parse time so `[1,2,3]::FLOAT[3]` stays
        a Const the index matcher can bind (`rewrite.match_distance_order`
        requires Func(column, Const))."""
        from vss_tpu_torch.query.ir import Cast

        while self.accept_op("::"):
            tname = self.ident().upper()
            dims = None
            if self.accept_op("["):
                k2, d = self.next()
                if k2 != "num":
                    raise BinderError("cast array type needs a size")
                self.expect_op("]")
                dims = int(d)
            if (
                isinstance(e, Const)
                and e.value is not None
                and not isinstance(e.value, str)
            ):
                v = np.asarray(e.value)
                if dims is not None:
                    if v.ndim == 1 and v.shape[0] != dims:
                        raise BinderError(
                            f"cannot cast array of size {v.shape[0]} to "
                            f"{tname}[{dims}]"
                        )
                    e = Const(v.astype(np.float32))
                elif tname in ("FLOAT", "REAL", "DOUBLE") and v.ndim == 0:
                    e = Const(float(v))
                elif (
                    tname in ("INT", "INTEGER", "BIGINT", "SMALLINT")
                    and v.ndim == 0
                ):
                    e = Const(int(v))
                else:
                    e = Cast(e, tname, dims)
            else:
                e = Cast(e, tname, dims)
        return e

    def _primary_base(self) -> Expr:
        kind, v = self.peek()
        if kind == "num":
            self.next()
            num = float(v)
            if re.fullmatch(r"-?\d+", v):
                return Const(int(v))
            return Const(num)
        if kind == "str":
            self.next()
            return Const(v[1:-1].replace("''", "'"))
        if kind == "op" and v == "[":
            return self._array_expr()
        if kind == "op" and v == "(":
            self.next()
            e = self.expr()
            self.expect_op(")")
            return e
        if kind == "id":
            up = v.upper()
            if up == "NULL":
                self.next()
                return Const(None)
            if up in ("TRUE", "FALSE"):
                self.next()
                return Const(up == "TRUE")
            if up == "ARRAY" and self.toks[self.i + 1][1] == "[":
                # ARRAY[...] literal prefix (hnsw_lateral_join.test:14)
                self.next()
                return self._array_expr()
            name = self.next()[1]
            if self.accept_op("("):
                args = []
                orders = None
                if self.accept_op("*"):  # count(*)
                    self.expect_op(")")
                    f = Func(name.lower(), [Const("*")])
                else:
                    if not self.accept_op(")"):
                        args.append(self.expr())
                        while self.accept_op(","):
                            args.append(self.expr())
                        # aggregate-internal ORDER BY: list(x ORDER BY k1, k2)
                        if self.accept_kw("ORDER"):
                            self.expect_kw("BY")
                            orders = self.order_key_list()
                        self.expect_op(")")
                    f = Func(name.lower(), args, orders=orders)
                # bare window: row_number() OVER () (hnsw_join_macro.test:10)
                if self.accept_kw("OVER"):
                    self.expect_op("(")
                    self.expect_op(")")
                # agg(...) FILTER (WHERE p)
                if self.accept_kw("FILTER"):
                    self.expect_op("(")
                    self.expect_kw("WHERE")
                    f.filter = self.expr()
                    self.expect_op(")")
                return f
            # qualified column reference: table.column
            if self.accept_op("."):
                col = self.ident()
                return ColumnRef(f"{name}.{col}")
            return ColumnRef(name)
        raise BinderError(f"unexpected token {v!r} in expression")

    def _array_expr(self) -> Expr:
        """`[e1, e2, ...]`: a Const vector when every element is a numeric
        literal, else an array_pack() expression evaluated row-wise (the
        `[random(), random(), random()]` form, hnsw_lateral_join_group)."""
        self.expect_op("[")
        elems: list[Expr] = []
        if not self.accept_op("]"):
            while True:
                elems.append(self.expr())
                if self.accept_op("]"):
                    break
                self.expect_op(",")
        if all(
            isinstance(e, Const) and np.ndim(e.value) == 0
            and not isinstance(e.value, (str, bool, type(None)))
            for e in elems
        ):
            return Const(np.asarray([float(e.value) for e in elems], np.float32))
        return Func("array_pack", elems)

    def order_key_list(self) -> list:
        """[(expr, ascending)], comma-separated with optional ASC/DESC."""
        keys = []
        while True:
            e = self.expr()
            asc = True
            if self.accept_kw("DESC"):
                asc = False
            else:
                self.accept_kw("ASC")
            keys.append((e, asc))
            if not self.accept_op(","):
                return keys

    def _array_literal(self) -> np.ndarray:
        self.expect_op("[")
        vals = []
        if not self.accept_op("]"):
            while True:
                kind, v = self.next()
                if kind != "num":
                    raise BinderError("array literals must contain numbers")
                vals.append(float(v))
                if self.accept_op("]"):
                    break
                self.expect_op(",")
        return np.asarray(vals, np.float32)

    def _literal(self) -> Any:
        kind, v = self.peek()
        if kind == "op" and v == "[":
            return self._array_literal()
        kind, v = self.next()
        if kind == "num":
            return int(v) if re.fullmatch(r"-?\d+", v) else float(v)
        if kind == "str":
            return v[1:-1].replace("''", "'")
        if kind == "id" and v.upper() in ("TRUE", "FALSE"):
            return v.upper() == "TRUE"
        if kind == "id" and v.upper() == "NULL":
            return None
        raise BinderError(f"expected literal, got {v!r}")


# ----------------------------------------------------------------- SELECT
# keywords that terminate a FROM item (so a bare identifier after a table
# name can be read as an alias)
_FROM_STOP = {
    "WHERE", "GROUP", "ORDER", "LIMIT", "LATERAL", "ON", "USING", "JOIN",
    "AS", "ASC", "DESC", "FILTER", "AND", "OR", "NOT", "SELECT", "FROM",
    "BY", "SET", "VALUES", "INTO", "OVER", "BETWEEN", "HAVING",
}


def _parse_select_items(p: _Parser):
    """Comma list of `*` / expr [AS] alias. Returns [(alias|None, expr|None)]
    where expr None means `*`."""
    items: list[tuple[Optional[str], Optional[Expr]]] = []
    while True:
        if p.accept_op("*"):
            items.append((None, None))
        else:
            e = p.expr()
            alias = None
            if p.accept_kw("AS"):
                alias = p.ident()
            else:
                kind, v = p.peek()
                if kind == "id" and v.upper() not in _FROM_STOP:
                    alias = p.ident()
            items.append((alias, e))
        if not p.accept_op(","):
            return items


def _maybe_alias(p: _Parser) -> Optional[str]:
    if p.accept_kw("AS"):
        return p.ident()
    kind, v = p.peek()
    if kind == "id" and v.upper() not in _FROM_STOP:
        return p.ident()
    return None


def _parse_lateral_subquery(p: _Parser) -> dict:
    """`( SELECT <items> FROM <table> [alias] [WHERE e] ORDER BY keys
    LIMIT k )` — the correlated subquery shape of the reference's lateral
    join tests (`test/sql/hnsw/hnsw_lateral_join.test:22-47`)."""
    p.expect_op("(")
    p.expect_kw("SELECT")
    items = _parse_select_items(p)
    p.expect_kw("FROM")
    table = p.ident()
    alias = _maybe_alias(p) or table
    where = None
    if p.accept_kw("WHERE"):
        where = p.expr()
    order_keys = []
    if p.accept_kw("ORDER"):
        p.expect_kw("BY")
        order_keys = p.order_key_list()
    if not p.accept_kw("LIMIT"):
        raise BinderError("LATERAL subquery requires ORDER BY ... LIMIT k")
    kind, v = p.next()
    if kind != "num":
        raise BinderError("LIMIT must be an integer")
    p.expect_op(")")
    return {
        "items": items, "table": table, "alias": alias, "where": where,
        "order_keys": order_keys, "k": int(v),
    }


def _lower_lateral(db, outer_table, outer_alias, sub) -> "PlanNode":
    from vss_tpu_torch.query.ir import LateralJoin

    inner = db.table(sub["table"])
    sub_items: list[tuple[str, Expr]] = []
    # seed with outer column names so sub-item output names never collide
    # with outer columns in the join's output chunk
    seen: dict[str, int] = {c: 1 for c in db.table(outer_table).column_names()}

    def out_name(alias, e):
        if alias:
            base = alias
        elif isinstance(e, ColumnRef):
            base = e.name.split(".")[-1]
        else:
            base = str(e)
        n = seen.get(base, 0)
        seen[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    for alias, e in sub["items"]:
        if e is None:  # * expands to the inner table's columns
            for c in inner.column_names():
                sub_items.append((out_name(None, ColumnRef(c)), ColumnRef(c)))
        else:
            sub_items.append((out_name(alias, e), e))
    if not sub["order_keys"]:
        raise BinderError("LATERAL subquery requires ORDER BY ... LIMIT k")
    return LateralJoin(
        Scan(outer_table), outer_table, outer_alias, sub["table"],
        sub["alias"], sub_items, sub["order_keys"], sub["k"], sub["where"],
    )


def _value_of(e: Expr):
    """Evaluate a VALUES-clause expression to a Python value (constant
    folding over a 1-row dummy chunk; Const passes through so NULL and
    strings keep their Python types)."""
    if isinstance(e, Const):
        return e.value
    v = np.asarray(e.evaluate({}))
    return v[0] if v.ndim >= 1 else v.item()


def _find_minby(e: Expr) -> Optional[Func]:
    if isinstance(e, Func) and e.name in ("min_by", "max_by"):
        return e
    for c in e.children():
        r = _find_minby(c)
        if r is not None:
            return r
    return None


def _replace_subexpr(e: Expr, target: Expr, repl: Expr) -> Expr:
    if e is target:
        return repl
    if isinstance(e, BinOp):
        return BinOp(
            e.op,
            _replace_subexpr(e.left, target, repl),
            _replace_subexpr(e.right, target, repl),
        )
    if isinstance(e, Func):
        f = Func(
            e.name,
            [_replace_subexpr(a, target, repl) for a in e.args],
            orders=e.orders,
        )
        f.filter = e.filter
        return f
    if isinstance(e, Not):
        return Not(_replace_subexpr(e.child, target, repl))
    from vss_tpu_torch.query.ir import Cast

    if isinstance(e, Cast):
        return Cast(_replace_subexpr(e.child, target, repl), e.type_name, e.dims)
    return e


def _parse_from_item(p: _Parser):
    """One FROM item: `table [alias]` or `fn(args) [alias [(colnames)]]`.
    Returns ("table", name, alias) or ("func", name, args, alias, cols)."""
    name = p.ident()
    if p.accept_op("("):
        args = []
        if not p.accept_op(")"):
            while True:
                kind, v = p.peek()
                if kind == "id" and p.toks[p.i + 1][1] not in ("(",):
                    args.append(p.next()[1])  # bare identifier: table/col name
                else:
                    args.append(p._literal())
                if p.accept_op(")"):
                    break
                p.expect_op(",")
        alias = _maybe_alias(p)
        cols = None
        if p.accept_op("("):  # range(1,10) ra(a) — output column names
            cols = [p.ident()]
            while p.accept_op(","):
                cols.append(p.ident())
            p.expect_op(")")
        return ("func", name.lower(), args, alias, cols)
    alias = _maybe_alias(p) or name
    return ("table", name, alias)


def _range_cross_product(items) -> "PlanNode":
    """FROM range(a,b) r1(x), range(a,b) r2(y), ... — the reference tests'
    data generator (`hnsw_basic.test:14`). Materialized eagerly (the grids
    are small: 9^3, 10^4); row order = first item varies slowest."""
    from vss_tpu_torch.query.ir import ChunkSource

    cols: list[tuple[str, np.ndarray]] = []
    for _, name, args, alias, colnames in items:
        vals = [int(a) for a in args]
        lo, hi = (0, vals[0]) if len(vals) == 1 else (vals[0], vals[1])
        cname = colnames[0] if colnames else "range"
        cols.append((cname, np.arange(lo, hi, dtype=np.int64)))
    sizes = [len(a) for _, a in cols]
    total = int(np.prod(sizes)) if sizes else 0
    data = {}
    for i, (cname, arr) in enumerate(cols):
        inner = int(np.prod(sizes[i + 1:])) if i + 1 < len(sizes) else 1
        outer = total // (len(arr) * inner)
        data[cname] = np.tile(np.repeat(arr, inner), outer)
    return ChunkSource("range", data)


# zero-arg table functions admissible in generic FROM cross products
_CROSSABLE_TABLE_FNS = {"pragma_database_size", "pragma_hnsw_index_info"}

# result-row guard for eager cross products (these are catalog/pragma
# joins, not data joins)
_CROSS_MAX_ROWS = 1_000_000


def _generic_cross_product(db: Database, items) -> "PlanNode":
    """FROM item, item, ... over tables / zero-arg table functions:
    eager cross product with columns exposed under alias-qualified names
    ("current.total_blocks") plus bare names for columns unique across
    the sources. The reclaim test reads pragma_database_size() against
    saved snapshot tables this way."""
    from vss_tpu_torch.query.ir import ChunkSource

    chunks: list[tuple[str, dict]] = []
    for it in items:
        if it[0] == "table":
            _, name, alias = it
            chunks.append((alias or name, dict(db.table(name).chunk())))
        else:
            _, name, args, alias, _cols = it
            src = _table_function(db, name, args)
            if not isinstance(src, ChunkSource):
                raise BinderError(
                    f"table function '{name}' not usable in a FROM list"
                )
            chunks.append((alias or name, dict(src.data)))
    sizes = [
        len(next(iter(c.values()))) if c else 0 for _, c in chunks
    ]
    total = int(np.prod(sizes)) if sizes else 0
    if total > _CROSS_MAX_ROWS:
        raise BinderError(
            f"cross product too large ({total} rows)"
        )
    bare_counts: dict[str, int] = {}
    for _, c in chunks:
        for col in c:
            bare_counts[col] = bare_counts.get(col, 0) + 1
    data: dict[str, np.ndarray] = {}
    for i, (alias, c) in enumerate(chunks):
        inner = int(np.prod(sizes[i + 1:])) if i + 1 < len(sizes) else 1
        outer = (total // (sizes[i] * inner)) if sizes[i] else 0
        for col, arr in c.items():
            tiled = np.tile(np.repeat(arr, inner, axis=0),
                            (outer,) + (1,) * (np.ndim(arr) - 1))
            data[f"{alias}.{col}"] = tiled
            if bare_counts[col] == 1 and not col.startswith("__"):
                data[col] = tiled
    return ChunkSource("cross_product", data)


def _parse_select(p: _Parser, db: Database) -> PlanNode:
    from vss_tpu_torch.query.ir import ChunkSource

    p.expect_kw("SELECT")
    items = _parse_select_items(p)
    lateral = None
    src = None
    src_alias = None
    if not p.accept_kw("FROM"):
        # SELECT without FROM (`SELECT setseed(0.1337)`): one dummy row
        node = ChunkSource("dual", {"__dual__": np.zeros(1, np.int64)})
    elif p.accept_op("("):
        # FROM (SELECT ...) [alias] — derived table (the slow lateral
        # file wraps its grouped lateral join in `SELECT count(*) FROM
        # (...)`) ; must be the only FROM item
        node = _parse_select(p, db)
        p.expect_op(")")
        _maybe_alias(p)
    else:
        first = _parse_from_item(p)
        rest = []
        while p.accept_op(","):
            if p.accept_kw("LATERAL"):
                lateral = _parse_lateral_subquery(p)
                _maybe_alias(p)  # optional alias on the lateral item
                break
            rest.append(_parse_from_item(p))
        if first[0] == "table":
            src, src_alias = first[1], first[2]
        if lateral is not None:
            if first[0] != "table" or rest:
                raise BinderError("LATERAL requires a single left table")
            node = _lower_lateral(db, src, src_alias, lateral)
        elif not rest:
            if first[0] == "table":
                node = Scan(src)
            elif first[1] == "range":
                node = _range_cross_product([first])
            else:
                node = _table_function(db, first[1], first[2])
        elif all(it[0] == "func" and it[1] == "range" for it in (first, *rest)):
            node = _range_cross_product([first, *rest])
        elif (
            first[0] == "table"
            and len(rest) == 1
            and rest[0][0] == "func"
            and rest[0][1] == "vss_match"
        ):
            # correlated macro: FROM s, vss_match(t, s_col, t_col, k)
            # (`hnsw_join_macro.test:33`) — s_col ranges over s's rows
            from vss_tpu_torch.query.macros import vss_match_lateral

            args = rest[0][2]
            if len(args) not in (4, 5):
                raise BinderError(
                    "vss_match(right_table, left_col, right_col, k[, metric])"
                )
            data = vss_match_lateral(
                db, src, args[0], args[1], args[2], int(args[3]), *args[4:]
            )
            node = ChunkSource("vss_match", data)
        elif all(
            it[0] == "table"
            or (it[0] == "func" and it[1] in _CROSSABLE_TABLE_FNS)
            for it in (first, *rest)
        ):
            # small cross products of tables / zero-arg table functions
            # with alias-qualified columns: the reclaim test's
            # `FROM pragma_database_size() AS current, blocks_idx`
            node = _generic_cross_product(db, [first, *rest])
        else:
            raise BinderError(
                "unsupported FROM list (supported: table [, LATERAL (...)], "
                "range() cross products, table, vss_match(...))"
            )
    if p.accept_kw("WHERE"):
        node = Filter(node, p.expr())
    group_keys: list[str] = []
    having = None
    def _qual_ident():
        nm = p.ident()
        while p.accept_op("."):
            nm += "." + p.ident()
        return nm

    if p.accept_kw("GROUP"):
        p.expect_kw("BY")
        group_keys.append(_qual_ident())
        while p.accept_op(","):
            group_keys.append(_qual_ident())
        if p.accept_kw("HAVING"):
            # evaluated over the aggregated chunk: references group keys
            # and aggregate aliases (e.g. HAVING cnt > 2)
            having = p.expr()
    order = None
    ascending = True
    order_tail = None
    if p.accept_kw("ORDER"):
        p.expect_kw("BY")
        keys = p.order_key_list()
        order, ascending = keys[0]
        order_tail = keys[1:] or None
    limit = None
    if p.accept_kw("LIMIT"):
        kind, v = p.next()
        if kind != "num":
            raise BinderError("LIMIT must be an integer")
        limit = int(v)

    # min_by / max_by aggregate form, possibly nested inside an outer
    # scalar expression (`SELECT list_sum(flatten(min_by(...))) BETWEEN
    # 44 AND 50 FROM t1`, hnsw_topk.test:26-34)
    if len(items) == 1 and items[0][1] is not None and not group_keys:
        f = _find_minby(items[0][1])
        if f is not None:
            if len(f.args) != 3 or not isinstance(f.args[2], Const):
                raise BinderError(
                    f"{f.name}(value, order, k) requires constant k"
                )
            bare = items[0][1] is f
            out = (items[0][0] or f.name) if bare else "__minby"
            agg = MinByAgg(
                node, f.args[0], f.args[1], int(f.args[2].value), out,
                filter=f.filter, descending=(f.name == "max_by"),
            )
            if bare:
                return agg
            name = items[0][0] or str(items[0][1])
            wrapped = _replace_subexpr(items[0][1], f, ColumnRef(out))
            return Projection(agg, {name: wrapped})

    # aggregates: count(*)/count/sum/min/max/avg/list, optionally GROUP BY
    _AGGS = ("count", "sum", "min", "max", "avg", "list", "bool_and",
             "any_value")

    def _is_agg(e):
        return e is not None and isinstance(e, Func) and e.name in _AGGS

    def _agg_items(agg_list):
        out = {}
        for alias, e in agg_list:
            arg = e.args[0] if e.args else None
            if isinstance(arg, Const) and arg.value == "*":
                arg = None
            out[alias or f"{e.name}"] = (e.name, arg, e.orders, e.filter)
        return out

    if group_keys:
        from vss_tpu_torch.query.ir import Extend, GroupByAggregate

        aggs = [(a, e) for a, e in items if _is_agg(e)]
        non_aggs = [
            (a, e) for a, e in items if e is not None and not _is_agg(e)
        ]
        names = [
            a or (e.name.split(".")[-1] if isinstance(e, ColumnRef) else str(e))
            for a, e in non_aggs
        ]
        # `GROUP BY queries.id` with `SELECT queries.id AS id`: normalize
        # qualified group keys to the select item's output name when the
        # item's expression is that column (the slow lateral file's form)
        for gi, gk in enumerate(group_keys):
            if gk in names:
                continue
            for out_name, (a, e) in zip(names, non_aggs):
                if isinstance(e, ColumnRef) and (
                    e.name == gk
                    or e.name.split(".")[-1] == gk.split(".")[-1]
                ):
                    group_keys[gi] = out_name
                    break
        bad = [c for c in names if c not in group_keys]
        if bad:
            raise BinderError(
                f"column '{bad[0]}' must appear in GROUP BY or an aggregate"
            )
        # make select aliases visible as group-key columns
        ext = {
            n: e for n, (a, e) in zip(names, non_aggs)
        }
        if ext:
            node = Extend(node, ext)
        out: PlanNode = GroupByAggregate(node, group_keys, _agg_items(aggs))
        if having is not None:
            out = Filter(out, having)
        if order is not None:
            out = TopK(out, order, limit if limit is not None else 1 << 30,
                       ascending, tail=order_tail)
        elif limit is not None:
            out = Limit(out, limit)
        return out

    if items and all(_is_agg(e) for _, e in items):
        from vss_tpu_torch.query.ir import SimpleAggregate

        return SimpleAggregate(node, _agg_items(items))

    # ORDER BY may reference select aliases (`SELECT dist(...) as x ...
    # ORDER BY x`, hnsw_result.test:22); the TopK sits below the
    # projection, so substitute the aliased expression into the key
    alias_map = {
        a: e for a, e in items if a is not None and e is not None
    }
    def _resolve_alias(e):
        if isinstance(e, ColumnRef) and e.name in alias_map:
            return alias_map[e.name]
        return e

    if order is not None:
        order = _resolve_alias(order)
        if order_tail:
            order_tail = [(_resolve_alias(e), asc) for e, asc in order_tail]

    if order is not None and limit is not None:
        node = TopK(node, order, limit, ascending, tail=order_tail)
    elif order is not None:
        node = TopK(node, order, 1 << 30, ascending, tail=order_tail)
    elif limit is not None:
        node = Limit(node, limit)

    # A bare `select *` over a plain table can return the scan chunk as-is,
    # but over a lateral join the raw output carries qualified duplicates
    # (`a.a_vec`) for correlation scoping — those must be projected away so
    # the user-visible row shape matches DuckDB's star expansion
    # (hnsw_lateral_join.test:21 expects exactly outer+sub columns).
    if not (len(items) == 1 and items[0][1] is None and lateral is None):
        exprs: dict[str, Expr] = {}
        if src in db.tables:
            table_cols = db.table(src).column_names()
        else:
            table_cols = []
        if lateral is not None:
            from vss_tpu_torch.query.ir import LateralJoin as _LJ

            j = node
            while not isinstance(j, (_LJ,)) and j.children():
                j = j.children()[0]
            star_cols = (
                [c for c in db.table(src).column_names()]
                + [n for n, _ in j.sub_items]
            ) if isinstance(j, _LJ) else table_cols
        else:
            star_cols = table_cols
        for alias, e in items:
            if e is None:
                for c in star_cols:
                    exprs[c] = ColumnRef(c)
                continue
            name = alias or (
                e.name.split(".")[-1] if isinstance(e, ColumnRef) else str(e)
            )
            exprs[name] = e
        node = Projection(node, exprs)
    return node


def _table_function(db: Database, name: str, args: list):
    """FROM-clause table functions: pragma_hnsw_index_info(), and the
    matching helpers the reference registers as SQL macros
    (`hnsw_index_macros.cpp`): vss_join / vss_match, plus knn_join (the
    LATERAL top-k join surface)."""
    from vss_tpu_torch.query.ir import ChunkSource, ColumnRef, KNNJoin, Scan

    if name == "pragma_hnsw_index_info":
        if args:
            raise BinderError("pragma_hnsw_index_info takes no arguments")
        # column-exact reproduction of the reference's 11-column schema
        # (hnsw_index_pragmas.cpp:41-80), incl. the levels_stats LIST of
        # STRUCT(nodes, edges, max_edges, allocated_bytes). The richer
        # engine-native dict (deleted counts, quantization drift, shard
        # count, ...) stays on Database.hnsw_index_info().
        rows = db.hnsw_index_info()
        ls = np.empty(len(rows), object)
        for i, r in enumerate(rows):
            ls[i] = [
                {
                    "nodes": lv["nodes"],
                    "edges": lv["edges"],
                    "max_edges": lv["max_edges"],
                    "allocated_bytes": lv.get("allocated_bytes", 0),
                }
                for lv in r["levels"]
            ]
        data = {
            "catalog_name": np.asarray(["memory"] * len(rows), object),
            "schema_name": np.asarray(["main"] * len(rows), object),
            "index_name": np.asarray([r["index_name"] for r in rows], object),
            "table_name": np.asarray([r["table_name"] for r in rows], object),
            "metric": np.asarray([r["metric"] for r in rows], object),
            "dimensions": np.asarray(
                [r["dimensions"] for r in rows], np.int64
            ),
            "count": np.asarray([r["count"] for r in rows], np.int64),
            "capacity": np.asarray([r["capacity"] for r in rows], np.int64),
            "approx_memory_usage": np.asarray(
                [r["approx_memory_bytes"] for r in rows], np.int64
            ),
            # stats->max_level (0-based top level), not the level count
            "levels": np.asarray(
                [max(r["num_levels"] - 1, 0) for r in rows], np.int64
            ),
            "levels_stats": ls,
        }
        return ChunkSource("pragma_hnsw_index_info()", data)
    if name == "pragma_database_size":
        if args:
            raise BinderError("pragma_database_size takes no arguments")
        size = db.database_size()
        data = {k: np.asarray([v]) for k, v in size.items()}
        return ChunkSource("pragma_database_size()", data)
    if name == "vss_join":
        from vss_tpu_torch.query.macros import vss_join

        if len(args) not in (5, 6):
            raise BinderError(
                "vss_join(left_table, right_table, left_col, right_col, k"
                "[, metric])"
            )
        data = vss_join(db, *args[:4], int(args[4]), *args[5:])
        return ChunkSource("vss_join", data)
    if name == "vss_match":
        from vss_tpu_torch.query.macros import vss_match

        if len(args) not in (4, 5):
            raise BinderError(
                "vss_match(right_table, query_vector, right_col, k[, metric])"
            )
        data = vss_match(db, args[0], args[1], args[2], int(args[3]), *args[4:])
        return ChunkSource("vss_match", data)
    if name == "knn_join":
        if len(args) not in (5, 6):
            raise BinderError(
                "knn_join(left_table, right_table, left_col, right_col, k"
                "[, distance_function])"
            )
        left, right, lcol, rcol, k = args[:5]
        fn_name = args[5] if len(args) == 6 else "array_distance"
        return KNNJoin(Scan(left), right, ColumnRef(lcol), rcol, int(k), fn_name)
    raise BinderError(f"unknown table function '{name}'")


_TYPE_MAP = {
    "INT": np.int64, "INTEGER": np.int64, "BIGINT": np.int64,
    "SMALLINT": np.int64, "TINYINT": np.int64,
    "FLOAT": np.float32, "REAL": np.float32, "DOUBLE": np.float64,
    "VARCHAR": object, "TEXT": object, "STRING": object,
    "BOOL": np.bool_, "BOOLEAN": np.bool_,
}


def execute_sql(db: Database, text: str):
    """Execute SQL; returns the last statement's result dict (SELECT/
    EXPLAIN/pragma info) or None for DDL/DML. Multiple statements may be
    separated by ';' (string literals are ';'-safe)."""
    statements = _split_statements(text)
    result = None
    for stmt in statements:
        result = _execute_one(db, stmt)
    return result


def _split_statements(text: str) -> list[str]:
    out, cur, in_str = [], [], False
    i = 0
    while i < len(text):
        ch = text[i]
        if in_str:
            cur.append(ch)
            if ch == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    cur.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            cur.append(ch)
        elif ch == ";":
            if "".join(cur).strip():
                out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


def _execute_one(db: Database, text: str):
    p = _Parser(text)
    kind, v = p.peek()
    if kind != "id":
        raise BinderError(f"cannot parse statement starting with {v!r}")
    kw = v.upper()

    if kw == "EXPLAIN":
        p.next()
        analyze = bool(p.accept_kw("ANALYZE"))
        plan = _parse_select(p, db)
        if analyze:
            report, _ = db.explain_analyze(plan)
            return {"explain": [report]}
        from vss_tpu_torch.query.rewrite import optimize

        return {"explain": [format_plan(optimize(db, plan))]}

    if kw == "SELECT":
        plan = _parse_select(p, db)
        return db.execute(plan)

    if kw == "CREATE":
        p.next()
        what = p.ident().upper()
        if what == "TABLE":
            name = p.ident()
            if p.accept_kw("AS"):
                # CREATE TABLE name AS SELECT ... (the reclaim test's
                # data generator and snapshot tables)
                plan = _parse_select(p, db)
                from vss_tpu_torch.query.exec import run_plan
                from vss_tpu_torch.query.rewrite import optimize

                chunk = run_plan(db, optimize(db, plan))
                cols = {
                    k: np.asarray(v) for k, v in chunk.items()
                    if not k.startswith("__") and "." not in k
                }
                db.create_table(name, cols)
                return None
            p.expect_op("(")
            cols: dict[str, np.ndarray] = {}
            while True:
                cname = p.ident()
                ctype = p.ident().upper()
                if ctype not in _TYPE_MAP:
                    raise BinderError(f"unknown column type '{ctype}'")
                if p.accept_op("["):
                    k2, dim = p.next()
                    if k2 != "num":
                        raise BinderError("array type needs a size: FLOAT[N]")
                    p.expect_op("]")
                    cols[cname] = np.zeros((0, int(dim)), np.float32)
                else:
                    cols[cname] = np.zeros((0,), _TYPE_MAP[ctype])
                if p.accept_op(")"):
                    break
                p.expect_op(",")
            db.create_table(name, cols)
            return None
        if what == "INDEX":
            name = p.ident()
            p.expect_kw("ON")
            table = p.ident()
            p.expect_kw("USING")
            using = p.ident()
            if using.upper() != "HNSW":
                raise BinderError(f"unknown index type '{using}'")
            p.expect_op("(")
            column = p.ident()
            p.expect_op(")")
            opts: dict[str, Any] = {}
            if p.accept_kw("WITH"):
                p.expect_op("(")
                while True:
                    k2 = p.ident()
                    p.expect_op("=")
                    val = p._literal()
                    kl = k2.lower()
                    if kl == "metric":
                        if not isinstance(val, str):
                            raise BinderError("HNSW index 'metric' must be a string")
                        opts["metric"] = val
                    elif kl == "ef_construction":
                        if not isinstance(val, int) or isinstance(val, bool):
                            raise BinderError(
                                "HNSW index 'ef_construction' must be an integer"
                            )
                        opts["ef_construction"] = val
                    elif kl == "ef_search":
                        if not isinstance(val, int) or isinstance(val, bool):
                            raise BinderError(
                                "HNSW index 'ef_search' must be an integer"
                            )
                        opts["ef_search"] = val
                    elif kl == "m":
                        if not isinstance(val, int) or isinstance(val, bool):
                            raise BinderError("HNSW index 'M' must be an integer")
                        opts["m"] = val
                    elif kl == "m0":
                        if not isinstance(val, int) or isinstance(val, bool):
                            raise BinderError("HNSW index 'M0' must be an integer")
                        opts["m0"] = val
                    elif kl == "storage":
                        if not isinstance(val, str):
                            raise BinderError(
                                "HNSW index 'storage' must be a string"
                            )
                        opts["storage"] = val
                    elif kl == "sharded":
                        if not isinstance(val, bool):
                            raise BinderError(
                                "HNSW index 'sharded' must be a boolean"
                            )
                        opts["sharded"] = val
                    else:
                        raise BinderError(
                            f"Unknown option for HNSW index: '{k2}'"
                        )
                    if p.accept_op(")"):
                        break
                    p.expect_op(",")
            db.create_hnsw_index(name, table, column, **opts)
            return None
        raise BinderError(f"cannot CREATE {what}")

    if kw == "INSERT":
        p.next()
        p.expect_kw("INTO")
        table = p.ident()
        t = db.table(table)
        col_list = None
        if p.accept_op("("):  # INSERT INTO t (a, b) ...
            col_list = [p.ident()]
            while p.accept_op(","):
                col_list.append(p.ident())
            p.expect_op(")")
        names = col_list or t.column_names()
        if sorted(names) != sorted(t.column_names()):
            raise BinderError(
                "INSERT column list must cover the full table schema"
            )
        if p.accept_kw("VALUES"):
            data: dict[str, list] = {c: [] for c in names}
            while True:
                p.expect_op("(")
                for j, c in enumerate(names):
                    if j:
                        p.expect_op(",")
                    data[c].append(_value_of(p.expr()))
                p.expect_op(")")
                if not p.accept_op(","):
                    break
            # keep raw python lists: Table.append maps None -> NULL (NaN)
            db.insert(table, data)
            return None
        # INSERT INTO t [cols] SELECT ... (hnsw_basic.test:14)
        plan = _parse_select(p, db)
        res = db.execute(plan)
        vals = list(res.values())
        if len(vals) != len(names):
            raise BinderError(
                f"INSERT expects {len(names)} columns, SELECT produced "
                f"{len(vals)}"
            )
        db.insert(table, {c: np.asarray(v) for c, v in zip(names, vals)})
        return None

    if kw == "DELETE":
        p.next()
        p.expect_kw("FROM")
        table = p.ident()
        t = db.table(table)
        if p.accept_kw("WHERE"):
            pred = p.expr()
            chunk = t.chunk()
            mask = np.asarray(pred.evaluate(chunk), bool)
            rowids = chunk["__rowid__"][mask]
        else:
            rowids = t.chunk()["__rowid__"]
        db.delete(table, rowids.tolist())
        return None

    if kw == "UPDATE":
        p.next()
        table = p.ident()
        t = db.table(table)
        p.expect_kw("SET")
        sets: dict[str, Expr] = {}
        while True:
            cname = p.ident()
            p.expect_op("=")
            sets[cname] = p.expr()
            if not p.accept_op(","):
                break
        chunk = t.chunk()
        if p.accept_kw("WHERE"):
            mask = np.asarray(p.expr().evaluate(chunk), bool)
        else:
            mask = np.ones(len(chunk["__rowid__"]), bool)
        rowids = chunk["__rowid__"][mask]
        sub = {c: v[mask] for c, v in chunk.items()}
        data = {c: np.asarray(e.evaluate(sub)) for c, e in sets.items()}
        db.update(table, rowids.tolist(), data)
        return None

    if kw == "PRAGMA":
        p.next()
        name = p.ident()
        if name.lower() == "hnsw_compact_index":
            p.expect_op("(")
            idx = p._literal()
            p.expect_op(")")
            db.hnsw_compact_index(str(idx))
            return None
        if name.lower() in ("disable_optimizer", "enable_optimizer"):
            # DuckDB core pragmas the reference tests toggle around their
            # index-vs-no-index parity checks (hnsw_rewrite.test:20)
            db.set_setting(
                "disable_optimizer", name.lower() == "disable_optimizer"
            )
            return None
        raise BinderError(f"unknown pragma '{name}'")

    if kw == "SET":
        p.next()
        name = p.ident()
        p.expect_op("=")
        db.set_setting(name, p._literal())
        return None

    if kw == "DROP":
        p.next()
        what = p.ident().upper()
        name = p.ident()
        if what == "TABLE":
            db.drop_table(name)
        elif what == "INDEX":
            db.drop_index(name)
        else:
            raise BinderError(f"cannot DROP {what}")
        return None

    if kw == "CHECKPOINT":
        p.next()
        kind, v = p.peek()
        path = None
        if kind == "str":
            path = p._literal()
        db.checkpoint(path)
        return None

    raise BinderError(f"unsupported statement '{kw}'")


def parse_statement(db: Database, text: str) -> PlanNode:
    p = _Parser(text)
    return _parse_select(p, db)
