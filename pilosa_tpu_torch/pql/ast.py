"""PQL AST (reference pql/ast.go): Query{calls} / Call{name,args,children} /
Condition{op,value}."""

from __future__ import annotations

from typing import Any, Optional

# condition tokens (reference pql/token.go:20-32)
EQ = "=="
NEQ = "!="
LT = "<"
LTE = "<="
GT = ">"
GTE = ">="
BETWEEN = "><"

COND_OPS = (BETWEEN, LTE, GTE, EQ, NEQ, LT, GT)

# Calls that write (reference ast.go:211 WriteCallN)
WRITE_CALLS = {"Set", "SetRowAttrs", "SetColumnAttrs", "Clear", "SetValue"}


class Condition:
    """An operation & value attached to a field arg (reference ast.go:415)."""

    __slots__ = ("op", "value")

    def __init__(self, op: str, value: Any) -> None:
        self.op = op
        self.value = value

    def int_slice_value(self) -> list[int]:
        if not isinstance(self.value, list):
            raise ValueError(f"expected list condition value, got {self.value!r}")
        out = []
        for v in self.value:
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f"expected int in condition list, got {v!r}")
            out.append(v)
        return out

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Condition)
            and self.op == other.op
            and self.value == other.value
        )

    def __repr__(self) -> str:
        return f"Condition({self.op!r}, {self.value!r})"

    def string_with_field(self, field: str) -> str:
        # BETWEEN prints as the `><` operator form so strings re-parse
        # without re-applying the conditional-form bound adjustments.
        return f"{field} {self.op} {format_value(self.value)}"


class Call:
    __slots__ = ("name", "args", "children")

    def __init__(
        self,
        name: str,
        args: Optional[dict[str, Any]] = None,
        children: Optional[list["Call"]] = None,
    ) -> None:
        self.name = name
        self.args = args if args is not None else {}
        self.children = children if children is not None else []

    # -- arg helpers (reference ast.go:257-330) --

    def field_arg(self) -> str:
        """The single non-underscore arg key, e.g. Set(col, field=row)."""
        for k in self.args:
            if not k.startswith("_"):
                return k
        raise ValueError("No field argument specified")

    def uint_arg(self, key: str) -> tuple[int, bool]:
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"could not convert {v!r} to uint in arg {key!r}")
        return v & 0xFFFFFFFFFFFFFFFF, True

    def uint_slice_arg(self, key: str) -> tuple[list[int], bool]:
        if key not in self.args:
            return [], False
        v = self.args[key]
        if not isinstance(v, list):
            raise ValueError(f"unexpected type for arg {key!r}: {v!r}")
        out = []
        for x in v:
            if isinstance(x, bool) or not isinstance(x, int):
                raise ValueError(f"unexpected element in {key!r}: {x!r}")
            out.append(x & 0xFFFFFFFFFFFFFFFF)
        return out, True

    def string_arg(self, key: str) -> tuple[str, bool]:
        if key not in self.args:
            return "", False
        v = self.args[key]
        if not isinstance(v, str):
            raise ValueError(f"could not convert {v!r} to string in arg {key!r}")
        return v, True

    def has_condition_arg(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def keys(self) -> list[str]:
        return sorted(self.args)

    def clone(self) -> "Call":
        args = {}
        for k, v in self.args.items():
            if isinstance(v, list):
                args[k] = list(v)
            elif isinstance(v, Condition):
                args[k] = Condition(v.op, list(v.value) if isinstance(v.value, list) else v.value)
            else:
                args[k] = v
        return Call(self.name, args, [c.clone() for c in self.children])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Call)
            and self.name == other.name
            and self.args == other.args
            and self.children == other.children
        )

    def __str__(self) -> str:
        """Serialize back to PARSEABLE PQL. The remote-execution leg
        re-sends calls as text (reference remoteExec,
        executor.go:1393-1440 sends q.String()), so every special form
        must invert its parse exactly — the internal ``_``-prefixed
        args are positional syntax, not named arguments:

          TopN(field, child?, args)      SetRowAttrs(field, row, args)
          Set(col, args, timestamp?)     Clear/SetColumnAttrs(col, args)
          Range(field=row, start, end)
        """
        name = self.name or "!UNNAMED"
        special = name in (
            "Set",
            "Clear",
            "SetColumnAttrs",
            "SetRowAttrs",
            "TopN",
            "Rows",
            "Range",
        )
        parts: list[str] = []
        positional: set[str] = set()
        if special:
            # positional grammar of the special forms; track exactly
            # which reserved args the positional syntax covers — any
            # OTHER reserved arg still renders named below (the parser
            # accepts reserved names as ordinary args), so nothing is
            # ever silently dropped from the remote leg
            if "_field" in self.args:
                parts.append(str(self.args["_field"]))  # bare, never quoted
                positional.add("_field")
                if "_row" in self.args:
                    parts.append(str(self.args["_row"]))
                    positional.add("_row")
            elif "_col" in self.args:
                parts.append(format_value(self.args["_col"]))
                positional.add("_col")
            positional.update(
                k for k in ("_start", "_end", "_timestamp") if k in self.args
            )
        parts += [str(c) for c in self.children]
        for key in self.keys():
            if key in positional:
                continue  # rendered positionally above / below
            v = self.args[key]
            if isinstance(v, Condition):
                parts.append(v.string_with_field(key))
            else:
                parts.append(f"{key}={format_value(v)}")
        if special:
            # trailing positional timestamps render bare (quoting them
            # would fail the parser's timestamp grammar)
            if "_start" in self.args:
                parts.append(str(self.args["_start"]))
            if "_end" in self.args:
                parts.append(str(self.args["_end"]))
            if "_timestamp" in self.args:
                parts.append(str(self.args["_timestamp"]))
        return f"{name}({', '.join(parts)})"

    __repr__ = __str__


class Query:
    __slots__ = ("calls",)

    def __init__(self, calls: Optional[list[Call]] = None) -> None:
        self.calls = calls or []

    def write_call_n(self) -> int:
        return sum(1 for c in self.calls if c.name in WRITE_CALLS)

    def __str__(self) -> str:
        return "".join(str(c) for c in self.calls)

    __repr__ = __str__


def format_value(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # escape exactly what the parser's _quoted_string unescapes —
        # an unescaped quote in a value would re-parse as different PQL
        # on the remote leg (injection), or not parse at all
        s = (
            v.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )
        return f'"{s}"'
    if isinstance(v, list):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    if isinstance(v, float):
        # positional notation only: the PQL number grammar has no
        # exponent form, so str(1e-07) would re-parse as the STRING
        # '1e-07' on the remote leg — a silent type change. Keep a
        # decimal point so integral floats (1e22) don't re-parse as int.
        from decimal import Decimal

        s = format(Decimal(repr(v)), "f")
        return s if "." in s else s + ".0"
    return str(v)
