"""PQL parser — hand-written recursive descent over the reference's PEG
grammar (reference pql/pql.peg; the reference compiles it to a 2,850-line
parser machine, pql.peg.go — the grammar is small enough that descent is
clearer and equally fast).

Grammar summary:
    Calls    <- (Call)*
    Call     <- Set(col, args, timestamp?) / SetRowAttrs(field, row, args)
              / SetColumnAttrs(col, args) / Clear(col, args)
              / TopN(field, allargs?) / Range(timerange/conditional/arg)
              / IDENT(allargs)
    allargs  <- Call (, Call)* (, args)? / args / ε
    arg      <- field '=' value / field COND value
    COND     <- >< | <= | >= | == | != | < | >
    conditional <- int <[=] field <[=] int
"""

from __future__ import annotations

import re
from typing import Any, Optional

from pilosa_tpu_torch.pql.ast import BETWEEN, Call, Condition, Query

_TIMESTAMP_RE = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d$")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_RESERVED = {"_row", "_col", "_start", "_end", "_timestamp", "_field"}
# item bare-word charset (pql.peg `item`): letters digits - _ :
_WORD_RE = re.compile(r"[A-Za-z0-9_:-]+")
_NUM_RE = re.compile(r"-?(\d+(\.\d*)?|\.\d+)")
_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    # -- low-level helpers --

    def _ws(self, newlines: bool = True) -> None:
        chars = " \t\n" if newlines else " \t"
        while self.pos < len(self.text) and self.text[self.pos] in chars:
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, s: str) -> None:
        if not self.text.startswith(s, self.pos):
            raise ParseError(
                f"expected {s!r} at position {self.pos}: "
                f"{self.text[self.pos:self.pos+20]!r}"
            )
        self.pos += len(s)

    def _try(self, s: str) -> bool:
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def _match(self, regex: re.Pattern) -> Optional[str]:
        m = regex.match(self.text, self.pos)
        if m is None:
            return None
        self.pos = m.end()
        return m.group(0)

    # -- entry --

    def parse(self) -> Query:
        calls = []
        self._ws()
        while self.pos < len(self.text):
            calls.append(self._call())
            self._ws()
        return Query(calls)

    # -- call forms --

    def _call(self) -> Call:
        ident = self._match(_IDENT_RE)
        if ident is None:
            raise ParseError(f"expected call at position {self.pos}")
        self._ws(False)
        self._expect("(")
        self._ws(False)
        special = {
            "Set": self._set_call,
            "SetRowAttrs": self._set_row_attrs_call,
            "SetColumnAttrs": self._set_column_attrs_call,
            "Clear": self._clear_call,
            "TopN": self._topn_call,
            "Rows": self._rows_call,
            "Range": self._range_call,
        }.get(ident)
        if special is not None:
            # PEG ordered choice: if the positional form fails, backtrack
            # to the generic IDENT rule (reserved _col/_field/... args are
            # legal there) — this is how the reference round-trips
            # Call.String() for remote execution.
            save = self.pos
            try:
                call = special()
            except ParseError:
                self.pos = save
                call = self._generic_call(ident)
        else:
            call = self._generic_call(ident)
        self._ws(False)
        self._expect(")")
        self._ws(False)
        return call

    def _comma(self) -> bool:
        save = self.pos
        self._ws(False)
        if self._try(","):
            self._ws()
            return True
        self.pos = save
        return False

    def _col(self, call: Call) -> None:
        if self._peek() == '"':
            call.args["_col"] = self._quoted_string()
        else:
            n = self._match(_NUM_RE)
            if n is None or "." in n or n.startswith("-"):
                raise ParseError(f"expected column id at position {self.pos}")
            call.args["_col"] = int(n)

    def _set_call(self) -> Call:
        # Set(col, field=row[, timestamp])
        call = Call("Set")
        self._col(call)
        if not self._comma():
            raise ParseError("Set() requires arguments")
        while True:
            ts = self._try_timestamp()
            if ts is not None:
                call.args["_timestamp"] = ts
                break
            self._arg(call)
            if not self._comma():
                break
        return call

    def _try_timestamp(self) -> Optional[str]:
        save = self.pos
        w = self._match(_WORD_RE)
        if w is not None and _TIMESTAMP_RE.match(w):
            return w
        self.pos = save
        return None

    def _set_row_attrs_call(self) -> Call:
        call = Call("SetRowAttrs")
        field = self._match(_FIELD_RE)
        if field is None:
            raise ParseError("SetRowAttrs() requires a field")
        call.args["_field"] = field
        if not self._comma():
            raise ParseError("SetRowAttrs() requires a row")
        n = self._match(_NUM_RE)
        if n is None:
            raise ParseError("SetRowAttrs() requires a row id")
        call.args["_row"] = int(n)
        if self._comma():
            self._args(call)
        return call

    def _set_column_attrs_call(self) -> Call:
        call = Call("SetColumnAttrs")
        self._col(call)
        if self._comma():
            self._args(call)
        return call

    def _clear_call(self) -> Call:
        call = Call("Clear")
        self._col(call)
        if not self._comma():
            raise ParseError("Clear() requires arguments")
        self._args(call)
        return call

    def _topn_call(self) -> Call:
        call = Call("TopN")
        field = self._match(_FIELD_RE)
        if field is None:
            raise ParseError("TopN() requires a field")
        call.args["_field"] = field
        if self._comma():
            self._allargs(call)
        return call

    def _rows_call(self) -> Call:
        # Rows(field[, ids=[...]]) — a GroupBy dimension; same positional
        # field grammar as TopN
        call = Call("Rows")
        field = self._match(_FIELD_RE)
        if field is None:
            raise ParseError("Rows() requires a field")
        call.args["_field"] = field
        if self._comma():
            self._args(call)
        return call

    def _range_call(self) -> Call:
        call = Call("Range")
        # conditional: int <[=] field <[=] int
        save = self.pos
        if self._conditional(call):
            return call
        self.pos = save
        # timerange or single arg: field ('=' value , ts , ts) | COND value
        field = self._field_name()
        self._ws(False)
        op = self._cond_op()
        if op is None:
            self._expect("=")
            self._ws(False)
            value = self._value()
            if self._comma():
                start = self._timestamp_value()
                if not self._comma():
                    raise ParseError("Range() expects start and end timestamps")
                end = self._timestamp_value()
                call.args[field] = value
                call.args["_start"] = start
                call.args["_end"] = end
                return call
            call.args[field] = value
            return call
        self._ws(False)
        value = self._value()
        call.args[field] = Condition(op, value)
        return call

    def _conditional(self, call: Call) -> bool:
        """int <[=] field <[=] int → field: Condition(BETWEEN, [low, high]).

        NOTE (reference quirk, pql/ast.go:76-96 endConditional): the
        reference increments low for a strict '<' on the left but
        increments high for '<=' on the right — i.e. `a < f <= b` becomes
        BETWEEN [a+1, b+1]. Mirrored for parity.
        """
        n = self._match(re.compile(r"-?[1-9][0-9]*|0"))
        if n is None:
            return False
        self._ws(False)
        op1 = "<=" if self._try("<=") else ("<" if self._try("<") else None)
        if op1 is None:
            return False
        self._ws(False)
        field = self._match(_FIELD_RE)
        if field is None:
            return False
        self._ws(False)
        op2 = "<=" if self._try("<=") else ("<" if self._try("<") else None)
        if op2 is None:
            return False
        self._ws(False)
        m = self._match(re.compile(r"-?[1-9][0-9]*|0"))
        if m is None:
            return False
        low, high = int(n), int(m)
        if op1 == "<":
            low += 1
        if op2 == "<=":
            high += 1
        call.args[field] = Condition(BETWEEN, [low, high])
        return True

    def _generic_call(self, name: str) -> Call:
        call = Call(name)
        self._allargs(call)
        # trailing comma allowed (grammar: open allargs comma? close)
        self._comma()
        return call

    def _allargs(self, call: Call) -> None:
        # allargs <- Call (comma Call)* (comma args)? / args / sp
        self._ws(False)
        if self._peek() == ")":
            return
        if self._at_call():
            call.children.append(self._call())
            while True:
                save = self.pos
                if not self._comma():
                    break
                if self._at_call():
                    call.children.append(self._call())
                else:
                    self._args(call)
                    break
                continue
            return
        self._args(call)

    def _at_call(self) -> bool:
        """Lookahead: IDENT followed by '(' begins a nested call."""
        m = _IDENT_RE.match(self.text, self.pos)
        if m is None:
            return False
        p = m.end()
        while p < len(self.text) and self.text[p] in " \t":
            p += 1
        return p < len(self.text) and self.text[p] == "("

    # -- args --

    def _args(self, call: Call) -> None:
        while True:
            self._arg(call)
            if not self._comma():
                break
            if self._peek() == ")":
                break

    def _field_name(self) -> str:
        for r in _RESERVED:
            if self.text.startswith(r, self.pos):
                self.pos += len(r)
                return r
        f = self._match(_FIELD_RE)
        if f is None:
            raise ParseError(f"expected field name at position {self.pos}")
        return f

    def _cond_op(self) -> Optional[str]:
        for op in ("><", "<=", ">=", "==", "!=", "<", ">"):
            if self._try(op):
                return op
        return None

    def _arg(self, call: Call) -> None:
        field = self._field_name()
        self._ws(False)
        op = self._cond_op()
        if op is None:
            self._expect("=")
            self._ws(False)
            call.args[field] = self._value()
        else:
            self._ws(False)
            call.args[field] = Condition(op, self._value())

    # -- values --

    def _timestamp_value(self) -> str:
        if self._peek() in "\"'":
            q = self._peek()
            self.pos += 1
            m = self._match(_WORD_RE)
            self._expect(q)
        else:
            m = self._match(_WORD_RE)
        if m is None or not _TIMESTAMP_RE.match(m):
            raise ParseError(f"cannot parse timestamp at position {self.pos}")
        return m

    def _quoted_string(self) -> str:
        q = self._peek()
        assert q in "\"'"
        self.pos += 1
        out = []
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "\\" and self.pos + 1 < len(self.text):
                nxt = self.text[self.pos + 1]
                if nxt == "n":
                    out.append("\n")
                elif nxt in "\"'\\":
                    out.append(nxt)
                else:
                    out.append(ch + nxt)
                self.pos += 2
                continue
            if ch == q:
                self.pos += 1
                return "".join(out)
            if ch == "\n":
                break
            out.append(ch)
            self.pos += 1
        raise ParseError("unterminated string")

    def _value(self) -> Any:
        ch = self._peek()
        if ch == "[":
            self.pos += 1
            self._ws(False)
            items = []
            while self._peek() != "]":
                items.append(self._item())
                if not self._comma():
                    self._ws(False)
            self._expect("]")
            return items
        return self._item()

    def _item(self) -> Any:
        ch = self._peek()
        if ch in "\"'":
            return self._quoted_string()
        save = self.pos
        num = self._match(_NUM_RE)
        if num is not None:
            nxt = self.text[self.pos] if self.pos < len(self.text) else ""
            if not (nxt.isalnum() or nxt in "_:-"):
                return float(num) if "." in num else int(num)
            self.pos = save  # digits continue into a bare word (e.g. 2017-01-02)
        word = self._match(_WORD_RE)
        if word is None:
            raise ParseError(f"expected value at position {self.pos}")
        if word == "null":
            return None
        if word == "true":
            return True
        if word == "false":
            return False
        return word


def parse(text: str) -> Query:
    """Parse a PQL query string (reference pql.NewParser().Parse())."""
    return Parser(text).parse()
