"""microlua — a small Lua interpreter for the CLI scripting host.

The reference embeds liblua 5.4 (splinter_cli_cmd_lua.c:365-386); this build
image has no Lua, so the host is a from-scratch interpreter of the subset
that store scripts actually use:

  values      nil, boolean, integer, float, string, table, function,
              thread (coroutine)
  statements  local (multi), assignment (multi-target), calls, do/end,
              while, repeat/until, numeric & generic for, if/elseif/else,
              function (incl. methods, local function), return, break,
              goto / ::label:: (block-granular 5.4 visibility)
  exprs       full operator precedence (or/and, comparisons, .., + - * / //
              % ^, bitwise & | ~ << >> with lua 5.4 64-bit wrap +
              integer-representation rules, unary - not # ~), closures,
              varargs (...), method calls, table constructors
  metatables  setmetatable/getmetatable (incl. __metatable protection),
              __index/__newindex (table + function handlers, chained),
              arithmetic (__add __sub __mul __div __idiv __mod __pow
              __unm), bitwise (__band __bor __bxor __bnot __shl __shr),
              __concat, __eq/__lt/__le, __len, __call,
              __tostring — the full OO-style store-script surface
              (reference embeds liblua 5.4, splinter_cli_cmd_lua.c:365-386)
  stdlib      print, type, tostring, tonumber, pairs, ipairs, select,
              pcall, error, assert, rawget/rawset/rawequal/rawlen, unpack,
              string.(format sub len upper lower rep byte char find gsub),
              table.(insert remove concat unpack), math.(floor ceil abs min
              max sqrt huge pi fmod max min tointeger), os.(time clock),
              coroutine.(create resume yield status wrap close
              isyieldable running) — one daemon thread per coroutine in
              strict semaphore handoff, so yield crosses pcall and host
              calls — require (host-registered modules only)

Deliberately out of scope (scripts needing these belong in Python):
io/file access (the store IS the I/O).

Lua semantics kept faithfully: 1-based arrays, # border rule, integer vs
float arithmetic (/ is float, // is floor), .. coerces numbers, only nil
and false are falsy, multiple return values with explist adjustment.
"""
from __future__ import annotations

import math as _pymath
import threading as _pythreading
import time as _pytime
import weakref as _pyweakref
from dataclasses import dataclass
from typing import Any, Callable, Optional


_UNSET = object()


class LuaError(Exception):
    """Raised for lex/parse/runtime errors, carrying a lua-style message.

    `.value` is the original Lua error VALUE: `error(tbl)` must
    propagate tbl verbatim through pcall and coroutine boundaries
    (Lua 5.4 §2.3 — error objects are values, not strings), so the
    value rides the exception while the exception text stays the
    tostring coercion.  Interpreter-raised errors (syntax, arithmetic
    on nil, ...) have string values, matching liblua."""

    def __init__(self, message, value=_UNSET):
        super().__init__(message)
        self.value = message if value is _UNSET else value


# ===================================================================== lexer

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "goto", "if", "in", "local", "nil", "not", "or",
    "repeat", "return", "then", "true", "until", "while",
}

# multi-char operators first so maximal munch wins
_OPS = [
    "...", "..", "==", "~=", "<=", ">=", "//", "<<", ">>", "::",
    "+", "-", "*", "/", "%", "^", "#", "<", ">", "=",
    "&", "|", "~",
    "(", ")", "{", "}", "[", "]", ";", ":", ",", ".",
]


@dataclass
class Tok:
    kind: str          # name | number | string | op | keyword | eof
    value: Any
    line: int


def _lex(src: str) -> list[Tok]:
    toks: list[Tok] = []
    i, line, n = 0, 1, len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        # comments
        if src.startswith("--", i):
            if src.startswith("--[[", i):
                end = src.find("]]", i + 4)
                if end < 0:
                    raise LuaError(f"unfinished long comment at line {line}")
                line += src.count("\n", i, end)
                i = end + 2
            else:
                j = src.find("\n", i)
                i = n if j < 0 else j
            continue
        # long string
        if src.startswith("[[", i):
            end = src.find("]]", i + 2)
            if end < 0:
                raise LuaError(f"unfinished long string at line {line}")
            s = src[i + 2:end]
            if s.startswith("\n"):
                s = s[1:]
            toks.append(Tok("string", s, line))
            line += src.count("\n", i, end)
            i = end + 2
            continue
        # quoted string
        if c in "'\"":
            q, j, out = c, i + 1, []
            while j < n and src[j] != q:
                ch = src[j]
                if ch == "\n":
                    raise LuaError(f"unfinished string at line {line}")
                if ch == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    out.append({"n": "\n", "t": "\t", "r": "\r", "a": "\a",
                                "b": "\b", "f": "\f", "v": "\v", "\\": "\\",
                                "'": "'", '"': '"', "0": "\0",
                                "\n": "\n"}.get(esc, esc))
                    j += 2
                else:
                    out.append(ch)
                    j += 1
            if j >= n:
                raise LuaError(f"unfinished string at line {line}")
            toks.append(Tok("string", "".join(out), line))
            i = j + 1
            continue
        # number
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith(("0x", "0X"), i):
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF"):
                    j += 1
                toks.append(Tok("number", int(src[i:j], 16), line))
            else:
                isfloat = False
                while j < n and (src[j].isdigit() or src[j] in ".eE" or
                                 (src[j] in "+-" and src[j - 1] in "eE")):
                    if src[j] in ".eE":
                        isfloat = True
                    j += 1
                text = src[i:j]
                toks.append(Tok("number",
                                float(text) if isfloat else int(text), line))
            i = j
            continue
        # name / keyword
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Tok("keyword" if word in _KEYWORDS else "name",
                            word, line))
            i = j
            continue
        # operator
        for op in _OPS:
            if src.startswith(op, i):
                toks.append(Tok("op", op, line))
                i += len(op)
                break
        else:
            raise LuaError(f"unexpected character {c!r} at line {line}")
    toks.append(Tok("eof", None, line))
    return toks


# ====================================================================== AST
# Nodes are plain tuples (tag, ...) — compact and fast to dispatch on.

class _Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.p = 0

    # -- token helpers ---------------------------------------------------
    def peek(self) -> Tok:
        return self.toks[self.p]

    def next(self) -> Tok:
        t = self.toks[self.p]
        self.p += 1
        return t

    def check(self, kind: str, value: Any = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind: str, value: Any = None) -> Optional[Tok]:
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value: Any = None) -> Tok:
        t = self.peek()
        if not self.check(kind, value):
            want = value if value is not None else kind
            raise LuaError(
                f"line {t.line}: expected {want!r}, got {t.value!r}")
        return self.next()

    # -- grammar ---------------------------------------------------------
    def parse_chunk(self):
        body = self.parse_block()
        self.expect("eof")
        return body

    def parse_block(self):
        stmts = []
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "keyword" and t.value in (
                    "end", "else", "elseif", "until"):
                break
            if t.kind == "op" and t.value == ";":
                self.next()
                continue
            if t.kind == "keyword" and t.value == "return":
                self.next()
                exprs = []
                if not (self.peek().kind == "eof" or
                        (self.peek().kind == "keyword" and
                         self.peek().value in ("end", "else", "elseif",
                                               "until")) or
                        self.check("op", ";")):
                    exprs = self.parse_explist()
                self.accept("op", ";")
                stmts.append(("return", exprs, t.line))
                break
            stmts.append(self.parse_statement())
        seen_labels = set()
        for st in stmts:
            if st[0] == "label":
                if st[1] in seen_labels:
                    raise LuaError(f"line {st[2]}: label '{st[1]}' "
                                   "already defined")
                seen_labels.add(st[1])
        return stmts

    def parse_statement(self):
        t = self.peek()
        if t.kind == "keyword":
            if t.value == "local":
                return self.parse_local()
            if t.value == "if":
                return self.parse_if()
            if t.value == "while":
                self.next()
                cond = self.parse_exp()
                self.expect("keyword", "do")
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("while", cond, body, t.line)
            if t.value == "repeat":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "until")
                cond = self.parse_exp()
                return ("repeat", body, cond, t.line)
            if t.value == "for":
                return self.parse_for()
            if t.value == "do":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("do", body, t.line)
            if t.value == "function":
                return self.parse_function_stmt()
            if t.value == "break":
                self.next()
                return ("break", t.line)
            if t.value == "goto":
                self.next()
                name = self.expect("name").value
                return ("goto", name, t.line)
        if t.kind == "op" and t.value == "::":
            self.next()
            name = self.expect("name").value
            self.expect("op", "::")
            return ("label", name, t.line)
        # expression statement: call or assignment
        exp = self.parse_suffixed()
        if self.check("op", "=") or self.check("op", ","):
            targets = [exp]
            while self.accept("op", ","):
                targets.append(self.parse_suffixed())
            self.expect("op", "=")
            values = self.parse_explist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaError(f"line {t.line}: cannot assign to "
                                   f"{tgt[0]} expression")
            return ("assign", targets, values, t.line)
        if exp[0] not in ("call", "method"):
            raise LuaError(f"line {t.line}: syntax error near {t.value!r}")
        return ("exprstat", exp, t.line)

    def parse_local(self):
        t = self.expect("keyword", "local")
        if self.accept("keyword", "function"):
            name = self.expect("name").value
            func = self.parse_funcbody(t.line)
            return ("localfunc", name, func, t.line)
        names = [self.expect("name").value]
        while self.accept("op", ","):
            names.append(self.expect("name").value)
        values = []
        if self.accept("op", "="):
            values = self.parse_explist()
        return ("local", names, values, t.line)

    def parse_if(self):
        t = self.expect("keyword", "if")
        arms = []
        cond = self.parse_exp()
        self.expect("keyword", "then")
        arms.append((cond, self.parse_block()))
        els = None
        while True:
            nt = self.peek()
            if nt.kind == "keyword" and nt.value == "elseif":
                self.next()
                c = self.parse_exp()
                self.expect("keyword", "then")
                arms.append((c, self.parse_block()))
            elif nt.kind == "keyword" and nt.value == "else":
                self.next()
                els = self.parse_block()
                self.expect("keyword", "end")
                break
            else:
                self.expect("keyword", "end")
                break
        return ("if", arms, els, t.line)

    def parse_for(self):
        t = self.expect("keyword", "for")
        first = self.expect("name").value
        if self.accept("op", "="):        # numeric for
            start = self.parse_exp()
            self.expect("op", ",")
            stop = self.parse_exp()
            step = None
            if self.accept("op", ","):
                step = self.parse_exp()
            self.expect("keyword", "do")
            body = self.parse_block()
            self.expect("keyword", "end")
            return ("fornum", first, start, stop, step, body, t.line)
        names = [first]                   # generic for
        while self.accept("op", ","):
            names.append(self.expect("name").value)
        self.expect("keyword", "in")
        exprs = self.parse_explist()
        self.expect("keyword", "do")
        body = self.parse_block()
        self.expect("keyword", "end")
        return ("forin", names, exprs, body, t.line)

    def parse_function_stmt(self):
        t = self.expect("keyword", "function")
        target = ("name", self.expect("name").value, t.line)
        is_method = False
        while True:
            if self.accept("op", "."):
                target = ("index", target,
                          ("const", self.expect("name").value, t.line),
                          t.line)
            elif self.accept("op", ":"):
                target = ("index", target,
                          ("const", self.expect("name").value, t.line),
                          t.line)
                is_method = True
                break
            else:
                break
        func = self.parse_funcbody(t.line, is_method)
        return ("assign", [target], [func], t.line)

    def parse_funcbody(self, line: int, is_method: bool = False):
        self.expect("op", "(")
        params, varargs = [], False
        if is_method:
            params.append("self")
        if not self.check("op", ")"):
            while True:
                if self.accept("op", "..."):
                    varargs = True
                    break
                params.append(self.expect("name").value)
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        body = self.parse_block()
        self.expect("keyword", "end")
        return ("function", params, varargs, body, line)

    def parse_explist(self):
        exprs = [self.parse_exp()]
        while self.accept("op", ","):
            exprs.append(self.parse_exp())
        return exprs

    # precedence-climbing expression parser
    _BINPRI = {
        "or": (1, 1), "and": (2, 2),
        "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
        "~=": (3, 3), "==": (3, 3),
        "|": (4, 4), "~": (5, 5), "&": (6, 6),      # lua 5.4 §3.4.8
        "<<": (7, 7), ">>": (7, 7),
        "..": (9, 8),                       # right associative
        "+": (10, 10), "-": (10, 10),
        "*": (11, 11), "/": (11, 11), "//": (11, 11), "%": (11, 11),
        "^": (14, 13),                      # right associative
    }
    _UNARY_PRI = 12

    def parse_exp(self, limit: int = 0):
        t = self.peek()
        if (t.kind == "op" and t.value in ("-", "#", "~")) or \
                (t.kind == "keyword" and t.value == "not"):
            self.next()
            operand = self.parse_exp(self._UNARY_PRI)
            node = ("unop", t.value, operand, t.line)
        else:
            node = self.parse_simple()
        while True:
            t = self.peek()
            op = None
            if t.kind == "op" and t.value in self._BINPRI:
                op = t.value
            elif t.kind == "keyword" and t.value in ("and", "or"):
                op = t.value
            if op is None:
                break
            left_pri, right_pri = self._BINPRI[op]
            if left_pri <= limit:
                break
            self.next()
            rhs = self.parse_exp(right_pri)
            node = ("binop", op, node, rhs, t.line)
        return node

    def parse_simple(self):
        t = self.peek()
        if t.kind == "number" or t.kind == "string":
            self.next()
            return ("const", t.value, t.line)
        if t.kind == "keyword":
            if t.value == "nil":
                self.next()
                return ("const", None, t.line)
            if t.value == "true":
                self.next()
                return ("const", True, t.line)
            if t.value == "false":
                self.next()
                return ("const", False, t.line)
            if t.value == "function":
                self.next()
                return self.parse_funcbody(t.line)
        if t.kind == "op":
            if t.value == "...":
                self.next()
                return ("varargs", t.line)
            if t.value == "{":
                return self.parse_table()
        return self.parse_suffixed()

    def parse_table(self):
        t = self.expect("op", "{")
        array, hash_pairs = [], []
        while not self.check("op", "}"):
            if self.check("op", "["):
                self.next()
                k = self.parse_exp()
                self.expect("op", "]")
                self.expect("op", "=")
                hash_pairs.append((k, self.parse_exp()))
            elif (self.peek().kind == "name" and
                  self.toks[self.p + 1].kind == "op" and
                  self.toks[self.p + 1].value == "="):
                k = self.next().value
                self.next()
                hash_pairs.append((("const", k, t.line), self.parse_exp()))
            else:
                array.append(self.parse_exp())
            if not (self.accept("op", ",") or self.accept("op", ";")):
                break
        self.expect("op", "}")
        return ("table", array, hash_pairs, t.line)

    def parse_suffixed(self):
        t = self.peek()
        if t.kind == "name":
            self.next()
            node = ("name", t.value, t.line)
        elif self.accept("op", "("):
            inner = self.parse_exp()
            self.expect("op", ")")
            node = ("paren", inner, t.line)
        else:
            raise LuaError(f"line {t.line}: unexpected {t.value!r}")
        while True:
            t = self.peek()
            if self.accept("op", "."):
                name = self.expect("name").value
                node = ("index", node, ("const", name, t.line), t.line)
            elif self.accept("op", "["):
                k = self.parse_exp()
                self.expect("op", "]")
                node = ("index", node, k, t.line)
            elif self.accept("op", ":"):
                mname = self.expect("name").value
                args = self.parse_args(t.line)
                node = ("method", node, mname, args, t.line)
            elif self.check("op", "(") or self.check("string") or \
                    self.check("op", "{"):
                args = self.parse_args(t.line)
                node = ("call", node, args, t.line)
            else:
                break
        return node

    def parse_args(self, line: int):
        if self.check("string"):
            return [("const", self.next().value, line)]
        if self.check("op", "{"):
            return [self.parse_table()]
        self.expect("op", "(")
        args = []
        if not self.check("op", ")"):
            args = self.parse_explist()
        self.expect("op", ")")
        return args


# =================================================================== runtime

class LuaTable:
    """A Lua table: unified hash with Lua's # border semantics and an
    optional metatable (set via setmetatable; consulted by the runtime
    for __index/__newindex/arith/compare/__call/__len/__tostring)."""
    __slots__ = ("data", "metatable")

    def __init__(self, items: Optional[dict] = None):
        self.data: dict = dict(items) if items else {}
        self.metatable: Optional["LuaTable"] = None

    def get(self, key):
        key = _normkey(key)
        return self.data.get(key)

    def set(self, key, value):
        key = _normkey(key)
        if key is None:
            raise LuaError("table index is nil")
        if value is None:
            self.data.pop(key, None)
        else:
            self.data[key] = value

    def length(self) -> int:
        n = 0
        while (n + 1) in self.data:
            n += 1
        return n

    # python conveniences for host code
    def __iter__(self):
        return iter(self.data.items())

    def to_list(self) -> list:
        return [self.data[i] for i in range(1, self.length() + 1)]

    @staticmethod
    def from_list(items) -> "LuaTable":
        return LuaTable({i + 1: v for i, v in enumerate(items)})


def _normkey(key):
    # Lua: 2.0 and 2 are the same key, but true and 1 are NOT — wrap bools
    # so they cannot collide with integers in the python dict
    if isinstance(key, bool):
        return ("\0bool", key)
    if isinstance(key, float) and key.is_integer():
        return int(key)
    return key


def _denormkey(key):
    if isinstance(key, tuple) and len(key) == 2 and key[0] == "\0bool":
        return key[1]
    return key


class _Goto(Exception):
    """Control transfer to a ::label:: — caught by the nearest enclosing
    block that declares the label (lua 5.4 visibility, block-granular:
    the label must be in the same or an enclosing block; a goto can
    never enter a block).  Escaping the function body is a lua error."""

    def __init__(self, name: str, line: int):
        self.name = name
        self.line = line


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values: tuple):
        self.values = values


@dataclass
class _Env:
    vars: dict
    parent: Optional["_Env"]

    def lookup(self, name: str) -> Optional["_Env"]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None


class LuaFunction:
    __slots__ = ("params", "varargs", "body", "env", "name")

    def __init__(self, params, varargs, body, env, name="?"):
        self.params = params
        self.varargs = varargs
        self.body = body
        self.env = env
        self.name = name


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return "nan"
        if v == _pymath.inf:
            return "inf"
        if v == -_pymath.inf:
            return "-inf"
        if v.is_integer():
            return "%.1f" % v
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):012x}"
    if isinstance(v, LuaCoroutine):   # thread values (incl. the main
        return f"thread: 0x{id(v):012x}"   # thread) never leak a repr
    if isinstance(v, (LuaFunction,)) or callable(v):
        return f"function: 0x{id(v):012x}"
    return str(v)


def _truthy(v) -> bool:
    return v is not None and v is not False


def _tonumber(v, base=None):
    if base is not None:
        try:
            return int(str(v).strip(), int(base))
        except ValueError:
            return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            if s.lower().startswith(("0x", "-0x")):
                return int(s, 16)
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return None
    return None


def _arith_operand(v, op, line):
    n = _tonumber(v) if not isinstance(v, bool) else None
    if n is None:
        raise LuaError(f"line {line}: attempt to perform arithmetic ({op}) "
                       f"on a {lua_typename(v)} value")
    return n


_I64 = 1 << 64


def _wrap_i64(n: int) -> int:
    """Lua integers are 64-bit two's complement; bitwise results wrap."""
    return (n + (1 << 63)) % _I64 - (1 << 63)


def _int_operand(v, op, line):
    """Bitwise operand (lua 5.4 §3.4.2): integers and floats with an
    exact IN-RANGE integer value; anything else errors (a metamethod
    may still handle it).  Unlike arithmetic, 5.4 does NOT coerce
    strings for bitwise ops (lstrlib installs only arithmetic
    metamethods on strings), and an out-of-i64-range float is an
    error, not a wrap — scripts validated here must behave the same
    under the reference CLI's real liblua."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise LuaError(f"line {line}: attempt to perform bitwise "
                       f"operation ({op}) on a {lua_typename(v)} value")
    n = v
    if isinstance(n, float):
        # isfinite first: int(inf)/int(nan) raise raw Python errors,
        # which must never escape the LuaError contract
        if not _pymath.isfinite(n) or n != int(n) \
                or not (-(1 << 63) <= n < (1 << 63)):
            raise LuaError(f"line {line}: number has no integer "
                           f"representation")
        n = int(n)
    return _wrap_i64(n)


def lua_typename(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if isinstance(v, LuaCoroutine):
        return "thread"
    return "function"


class _CoClosed(Exception):
    """Unwinds a parked coroutine body when close() reclaims it."""


class LuaCoroutine:
    """A lua 5.4 coroutine: one daemon thread + two semaphores in strict
    handoff — exactly one of {resumer, coroutine} ever runs, so the
    interpreter state (steps budget, globals) needs no extra locking.

    A thread per coroutine is the honest mapping for a tree-walking
    interpreter (the python stack IS the coroutine's suspended state);
    it also means yield works across pcall, metamethods and host calls
    — fewer restrictions than C lua's unyieldable C boundary.

    OS threads are a bounded host resource, so they are accounted:
    at most max_coroutines live threads per runtime (the 257th create
    that actually starts a thread is a catchable lua error, like
    liblua's memory error on luaB_cocreate), coroutine.close() on a
    suspended coroutine UNWINDS its parked body (the thread exits and
    releases its slot, lua 5.4 close semantics), and a body thread
    always releases its slot on exit."""

    def __init__(self, fn, runtime: "LuaRuntime"):
        self.fn = fn
        self.rt = runtime
        self.status = "suspended"      # suspended|running|normal|dead
        self._thread: Optional[_pythreading.Thread] = None
        self._resume_sem = _pythreading.Semaphore(0)
        self._return_sem = _pythreading.Semaphore(0)
        self._xfer: tuple = ()         # resume()'s args for the body
        self._outcome = ("yield", ())  # ("yield"|"return"|"error", ...)
        self._closed = False

    def _body(self) -> None:
        try:
            vals = self.rt.call(self.fn, self._xfer)
            self._outcome = ("return", vals)
        except _CoClosed:
            self.rt._co_live -= 1      # reclaimed; nobody is waiting
            return
        except LuaError as exc:
            self._outcome = ("error", exc.value)   # value, not coerced
        except RecursionError:
            self._outcome = ("error", "stack overflow")
        except BaseException as exc:   # host bug: surface, don't hang
            self._outcome = ("error", f"{type(exc).__name__}: {exc}")
        self.rt._co_live -= 1
        self._return_sem.release()

    def resume(self, args: tuple) -> tuple:
        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status != "suspended":
            return (False, "cannot resume non-suspended coroutine")
        stack = self.rt._co_stack
        caller = stack[-1] if stack else None
        if caller is not None:
            caller.status = "normal"
        self.status = "running"
        stack.append(self)
        self._xfer = args
        if self._thread is None:
            try:
                if self.rt._co_live >= self.rt.max_coroutines:
                    raise RuntimeError(
                        f"too many live coroutines "
                        f"(max {self.rt.max_coroutines})")
                self.rt._co_live += 1
                self.rt._co_started.add(self)
                self._thread = _pythreading.Thread(
                    target=self._body, daemon=True,
                    name="microlua-coroutine")
                try:
                    self._thread.start()
                except BaseException:
                    self.rt._co_live -= 1
                    self._thread = None
                    raise
            except RuntimeError as exc:
                stack.pop()            # undo the push: catchable error
                if caller is not None:
                    caller.status = "running"
                self.status = "dead"
                raise LuaError(
                    f"cannot start coroutine: {exc}") from None
        else:
            self._resume_sem.release()
        self._return_sem.acquire()     # strict handoff: body ran
        stack.pop()
        if caller is not None:
            caller.status = "running"
        kind, payload = self._outcome
        if kind == "yield":
            self.status = "suspended"
            return (True,) + tuple(payload)
        self.status = "dead"
        if kind == "return":
            return (True,) + tuple(payload)
        return (False, payload)

    def yield_(self, args: tuple) -> tuple:
        self._outcome = ("yield", args)
        self._return_sem.release()
        self._resume_sem.acquire()     # parked until the next resume
        if self._closed:
            raise _CoClosed()
        return self._xfer

    # join budget for close(): module-level so hosts (and tests) can
    # tighten it without touching every call site
    CLOSE_JOIN_TIMEOUT_S = 5.0

    def close(self) -> bool:
        """Reclaim a suspended coroutine's thread (lua 5.4 close):
        the parked body unwinds via _CoClosed and exits.  Joined
        (bounded) so the slot release is synchronous — a script that
        closes then creates sees the freed slot.

        Returns False when the body thread did NOT exit within the
        join budget (a host frame swallowed the _CoClosed unwind):
        the _co_live slot is genuinely still occupied by a live
        thread, so it is NOT released — silently pretending the slot
        was freed would let unreclaimable threads accumulate past
        max_coroutines unseen.  Callers surface the failure
        (coroutine.close returns false + message, per 5.4)."""
        self.status = "dead"
        if self._thread is not None and self._thread.is_alive():
            self._closed = True
            self._resume_sem.release()
            self._thread.join(timeout=self.CLOSE_JOIN_TIMEOUT_S)
            if self._thread.is_alive():
                return False
        return True


class LuaRuntime:
    """One interpreter instance: globals + registered host modules."""

    MAX_STEPS_DEFAULT = 50_000_000

    MAX_COROUTINES_DEFAULT = 256

    def __init__(self, output: Optional[Callable[[str], None]] = None,
                 max_steps: int = MAX_STEPS_DEFAULT,
                 max_coroutines: int = MAX_COROUTINES_DEFAULT):
        self.globals: dict = {}
        self.modules: dict = {}
        self.output = output or (lambda s: print(s))
        self.max_steps = max_steps
        self.steps = 0
        self.max_coroutines = max_coroutines
        self._co_stack: list = []      # innermost running coroutine last
        self._co_live = 0              # live body threads (bounded)
        self._co_started: "_pyweakref.WeakSet" = _pyweakref.WeakSet()
        # the main thread IS a coroutine value in lua 5.4 (running()
        # returns it; status works on it); it has no body thread
        self._main_co = LuaCoroutine(None, self)
        self._main_co.status = "running"
        self._install_stdlib()

    # -- public API ------------------------------------------------------
    def close(self) -> None:
        """Unwind every still-suspended coroutine so its parked body
        thread exits.  Hosts that run many scripts (one runtime each)
        must call this — or use the runtime as a context manager — or
        each abandoned generator leaks an OS thread that pins the whole
        runtime object graph until process exit."""
        for co in list(self._co_started):
            if co.status == "suspended":
                co.close()

    def __enter__(self) -> "LuaRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def register_module(self, name: str, table: LuaTable) -> None:
        """Make `require(name)` (and the global `name`) resolve to table."""
        self.modules[name] = table
        self.globals[name] = table

    def run(self, src: str, script_args: Optional[list[str]] = None,
            chunk_name: str = "script") -> tuple:
        """Execute a chunk; returns its return values as a tuple."""
        ast = _Parser(_lex(src)).parse_chunk()
        arg = LuaTable({0: chunk_name})
        for i, a in enumerate(script_args or []):
            arg.set(i + 1, a)
        self.globals["arg"] = arg
        env = _Env(self.globals, None)
        self.steps = 0
        try:
            self.exec_block(ast, env, ())
        except _Return as r:
            return r.values
        except _Goto as g:
            raise LuaError(f"line {g.line}: no visible label "
                           f"'{g.name}' for goto") from None
        except _Break:
            raise LuaError("break outside a loop") from None
        return ()

    # -- metatable machinery ---------------------------------------------
    @staticmethod
    def _getmeta(v, event: str):
        """The handler for `event` from v's metatable, or None."""
        if isinstance(v, LuaTable) and v.metatable is not None:
            return v.metatable.get(event)
        return None

    def index_value(self, obj, key, line: int):
        """Table/string read honoring __index chains (lua 5.4
        semantics: raw hit wins; else a table handler is re-indexed, a
        function handler is called with (t, key))."""
        for _ in range(100):
            if isinstance(obj, LuaTable):
                raw = obj.get(key)
                if raw is not None:
                    return raw
                h = self._getmeta(obj, "__index")
                if h is None:
                    return None
                if isinstance(h, LuaTable):
                    obj = h
                    continue
                res = self.call(h, (obj, key))
                return res[0] if res else None
            if isinstance(obj, str):
                strlib = self.globals.get("string")
                if isinstance(strlib, LuaTable):   # "x":upper() idiom
                    return strlib.get(key)
                return None
            raise LuaError(f"line {line}: attempt to index a "
                           f"{lua_typename(obj)} value")
        raise LuaError(f"line {line}: '__index' chain too long; "
                       f"possible loop")

    def newindex_value(self, obj, key, value, line: int) -> None:
        """Table write honoring __newindex (raw hit or no handler
        writes raw; a table handler is re-assigned into, a function
        handler is called with (t, key, value))."""
        for _ in range(100):
            if not isinstance(obj, LuaTable):
                raise LuaError(f"line {line}: attempt to index a "
                               f"{lua_typename(obj)} value")
            h = self._getmeta(obj, "__newindex")
            if h is None or obj.get(key) is not None:
                obj.set(key, value)
                return
            if isinstance(h, LuaTable):
                obj = h
                continue
            self.call(h, (obj, key, value))
            return
        raise LuaError(f"line {line}: '__newindex' chain too long; "
                       f"possible loop")

    def tostring(self, v) -> str:
        """lua_tostring honoring __tostring."""
        h = self._getmeta(v, "__tostring")
        if h is not None:
            res = self.call(h, (v,))
            out = res[0] if res else None
            if not isinstance(out, str):
                raise LuaError("'__tostring' must return a string")
            return out
        return lua_tostring(v)

    def _binmeta(self, event: str, lv, rv, line: int, errmsg: str):
        """Dispatch a binary metamethod from either operand (left
        first, per lua), or raise the original error message."""
        h = self._getmeta(lv, event)
        if h is None:
            h = self._getmeta(rv, event)
        if h is None:
            raise LuaError(errmsg)
        res = self.call(h, (lv, rv))
        return res[0] if res else None

    def call(self, fn, args: tuple) -> tuple:
        """Call a Lua or host function with python args, tuple of results."""
        h = self._getmeta(fn, "__call")
        if h is not None:
            return self.call(h, (fn,) + args)
        if isinstance(fn, LuaFunction):
            env = _Env({}, fn.env)
            for i, p in enumerate(fn.params):
                env.vars[p] = args[i] if i < len(args) else None
            varargs = tuple(args[len(fn.params):]) if fn.varargs else ()
            try:
                self.exec_block(fn.body, env, varargs)
            except _Return as r:
                return r.values
            except _Goto as g:
                raise LuaError(f"line {g.line}: no visible label "
                               f"'{g.name}' for goto") from None
            except _Break:
                raise LuaError("break outside a loop") from None
            except RecursionError:
                # translate HERE, the one chokepoint every lua-level
                # call goes through (incl. metamethod dispatch, which
                # never passes the eval_multi 'call' branch), so a
                # runaway recursive script can never crash the host
                # with a raw python RecursionError
                raise LuaError("stack overflow") from None
            return ()
        if callable(fn):
            out = fn(*args)
            if out is None:
                return (None,)   # python None = lua nil (a real value);
            if isinstance(out, tuple):   # hosts return () for "no values"
                return out
            return (out,)
        raise LuaError(f"attempt to call a {lua_typename(fn)} value")

    # -- execution -------------------------------------------------------
    def _tick(self, line: int) -> None:
        self.steps += 1
        if self.steps > self.max_steps:
            raise LuaError(f"line {line}: script exceeded "
                           f"{self.max_steps} steps (runaway loop?)")

    def exec_block(self, stmts, env: _Env, varargs: tuple) -> None:
        i, n = 0, len(stmts)
        while i < n:
            try:
                self.exec_stmt(stmts[i], env, varargs)
            except _Goto as g:
                for j, st in enumerate(stmts):
                    if st[0] == "label" and st[1] == g.name:
                        # lua 5.4: a forward goto may not enter the
                        # scope of a local declared between it and the
                        # label — unless the label ends the block (the
                        # ::continue:: carve-out).  Checked when the
                        # jump executes, not at parse time.
                        if (j > i
                                and any(s[0] in ("local", "localfunc")
                                        for s in stmts[i + 1:j])
                                and any(s[0] != "label"
                                        for s in stmts[j + 1:])):
                            raise LuaError(
                                f"line {g.line}: goto '{g.name}' jumps"
                                " into the scope of a local") from None
                        if j <= i:
                            # a backward jump EXITS the scope of every
                            # local declared at/after the label — drop
                            # those bindings so lookups fall through
                            # to outer scopes again (lua 5.4 scoping).
                            # Known divergence: two same-name locals in
                            # ONE block share a slot in this flat env,
                            # so the pop exposes the OUTER binding, not
                            # the earlier same-block one (real lua
                            # alpha-renames; not worth a scope tree)
                            for s in stmts[j:i + 1]:
                                if s[0] == "local":
                                    for nm in s[1]:
                                        env.vars.pop(nm, None)
                                elif s[0] == "localfunc":
                                    env.vars.pop(s[1], None)
                        i = j + 1          # backward gotos loop; ticked
                        break              # per-statement like any loop
                else:
                    raise                  # label lives further out
                continue
            i += 1

    def exec_stmt(self, st, env: _Env, varargs: tuple) -> None:
        tag = st[0]
        self._tick(st[-1])
        if tag == "local":
            _, names, exprs, _line = st
            vals = self.eval_explist(exprs, env, varargs, len(names))
            for name, v in zip(names, vals):
                env.vars[name] = v
        elif tag == "assign":
            _, targets, exprs, _line = st
            vals = self.eval_explist(exprs, env, varargs, len(targets))
            for tgt, v in zip(targets, vals):
                self.assign(tgt, v, env, varargs)
        elif tag == "exprstat":
            self.eval_multi(st[1], env, varargs)
        elif tag == "if":
            _, arms, els, _line = st
            for cond, body in arms:
                if _truthy(self.eval(cond, env, varargs)):
                    self.exec_block(body, _Env({}, env), varargs)
                    return
            if els is not None:
                self.exec_block(els, _Env({}, env), varargs)
        elif tag == "while":
            _, cond, body, line = st
            while _truthy(self.eval(cond, env, varargs)):
                self._tick(line)
                try:
                    self.exec_block(body, _Env({}, env), varargs)
                except _Break:
                    break
        elif tag == "repeat":
            _, body, cond, line = st
            while True:
                self._tick(line)
                scope = _Env({}, env)
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
                # until sees the loop body's locals
                if _truthy(self.eval(cond, scope, varargs)):
                    break
        elif tag == "fornum":
            _, name, e_start, e_stop, e_step, body, line = st
            start = _arith_operand(self.eval(e_start, env, varargs),
                                   "for", line)
            stop = _arith_operand(self.eval(e_stop, env, varargs),
                                  "for", line)
            step = 1
            if e_step is not None:
                step = _arith_operand(self.eval(e_step, env, varargs),
                                      "for", line)
            if step == 0:
                raise LuaError(f"line {line}: 'for' step is zero")
            i = start
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                self._tick(line)
                scope = _Env({name: i}, env)
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
                i += step
        elif tag == "forin":
            _, names, exprs, body, line = st
            vals = self.eval_explist(exprs, env, varargs, 3)
            itf, state, ctrl = vals[0], vals[1], vals[2]
            while True:
                self._tick(line)
                rets = self.call(itf, (state, ctrl))
                first = rets[0] if rets else None
                if first is None:
                    break
                ctrl = first
                scope = _Env({}, env)
                for i2, nm in enumerate(names):
                    scope.vars[nm] = rets[i2] if i2 < len(rets) else None
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
        elif tag == "do":
            self.exec_block(st[1], _Env({}, env), varargs)
        elif tag == "localfunc":
            _, name, fexpr, _line = st
            env.vars[name] = None      # visible to its own body (recursion)
            env.vars[name] = self.eval(fexpr, env, varargs)
            if isinstance(env.vars[name], LuaFunction):
                env.vars[name].name = name
        elif tag == "return":
            _, exprs, _line = st
            raise _Return(self.eval_explist_open(exprs, env, varargs))
        elif tag == "break":
            raise _Break()
        elif tag == "label":
            pass                           # jump target only
        elif tag == "goto":
            raise _Goto(st[1], st[2])
        else:                          # pragma: no cover
            raise LuaError(f"unknown statement {tag}")

    def assign(self, tgt, value, env: _Env, varargs: tuple) -> None:
        if tgt[0] == "name":
            name = tgt[1]
            owner = env.lookup(name)
            (owner.vars if owner else self.globals)[name] = value
        else:  # index
            obj = self.eval(tgt[1], env, varargs)
            key = self.eval(tgt[2], env, varargs)
            self.newindex_value(obj, key, value, tgt[3])

    # -- expression evaluation -------------------------------------------
    def eval_explist(self, exprs, env, varargs, want: int) -> list:
        vals = list(self.eval_explist_open(exprs, env, varargs))
        while len(vals) < want:
            vals.append(None)
        return vals[:want]

    def eval_explist_open(self, exprs, env, varargs) -> tuple:
        """Lua explist adjustment: last expression expands multi-values."""
        if not exprs:
            return ()
        vals: list = []
        for e in exprs[:-1]:
            vals.append(self.eval(e, env, varargs))
        vals.extend(self.eval_multi(exprs[-1], env, varargs))
        return tuple(vals)

    def eval_multi(self, e, env, varargs) -> tuple:
        """Evaluate keeping multiple return values (calls, ...)."""
        tag = e[0]
        if tag == "call":
            fn = self.eval(e[1], env, varargs)
            args = self.eval_explist_open(e[2], env, varargs)
            try:
                return self.call(fn, args)
            except LuaError:
                raise
            except (_Break, _Return):
                raise
            except RecursionError:
                raise LuaError(f"line {e[3]}: stack overflow")
        if tag == "method":
            obj = self.eval(e[1], env, varargs)
            # __index-aware lookup: obj:method() on an instance whose
            # class methods live behind setmetatable(obj, {__index=C})
            fn = self.index_value(obj, e[2], e[4])
            if fn is None:
                raise LuaError(f"line {e[4]}: attempt to call a nil value "
                               f"(method '{e[2]}')")
            args = (obj,) + self.eval_explist_open(e[3], env, varargs)
            return self.call(fn, args)
        if tag == "varargs":
            return varargs
        return (self.eval(e, env, varargs),)

    def eval(self, e, env: _Env, varargs: tuple):
        tag = e[0]
        if tag == "const":
            return e[1]
        if tag == "name":
            owner = env.lookup(e[1])
            if owner is not None:
                return owner.vars[e[1]]
            return self.globals.get(e[1])
        if tag == "paren":
            return self.eval(e[1], env, varargs)
        if tag in ("call", "method", "varargs"):
            vals = self.eval_multi(e, env, varargs)
            return vals[0] if vals else None
        if tag == "index":
            obj = self.eval(e[1], env, varargs)
            key = self.eval(e[2], env, varargs)
            return self.index_value(obj, key, e[3])
        if tag == "function":
            _, params, va, body, _line = e
            return LuaFunction(params, va, body, env)
        if tag == "table":
            _, array, hash_pairs, _line = e
            t = LuaTable()
            if array:
                for i, ae in enumerate(array[:-1]):
                    t.set(i + 1, self.eval(ae, env, varargs))
                last = self.eval_multi(array[-1], env, varargs)
                for j, v in enumerate(last):
                    t.set(len(array) - 1 + j + 1, v)
            for ke, ve in hash_pairs:
                t.set(self.eval(ke, env, varargs),
                      self.eval(ve, env, varargs))
            return t
        if tag == "binop":
            return self.eval_binop(e, env, varargs)
        if tag == "unop":
            _, op, oe, line = e
            v = self.eval(oe, env, varargs)
            if op == "-":
                try:
                    return -_arith_operand(v, "-", line)
                except LuaError as exc:
                    h = self._getmeta(v, "__unm")
                    if h is None:
                        raise exc
                    res = self.call(h, (v, v))
                    return res[0] if res else None
            if op == "~":                     # bitwise not
                try:
                    return _wrap_i64(~_int_operand(v, "~", line))
                except LuaError as exc:
                    h = self._getmeta(v, "__bnot")
                    if h is None:
                        raise exc
                    res = self.call(h, (v, v))
                    return res[0] if res else None
            if op == "not":
                return not _truthy(v)
            if op == "#":
                if isinstance(v, str):
                    return len(v)
                h = self._getmeta(v, "__len")
                if h is not None:
                    res = self.call(h, (v,))
                    return res[0] if res else None
                if isinstance(v, LuaTable):
                    return v.length()
                raise LuaError(f"line {line}: attempt to get length of a "
                               f"{lua_typename(v)} value")
        raise LuaError(f"cannot evaluate {tag}")   # pragma: no cover

    def eval_binop(self, e, env, varargs):
        _, op, le, re_, line = e
        if op == "and":
            lv = self.eval(le, env, varargs)
            return self.eval(re_, env, varargs) if _truthy(lv) else lv
        if op == "or":
            lv = self.eval(le, env, varargs)
            return lv if _truthy(lv) else self.eval(re_, env, varargs)
        lv = self.eval(le, env, varargs)
        rv = self.eval(re_, env, varargs)
        if op == "..":
            for v in (lv, rv):
                if not isinstance(v, (str, int, float)) or \
                        isinstance(v, bool):
                    return self._binmeta(
                        "__concat", lv, rv, line,
                        f"line {line}: attempt to concatenate a "
                        f"{lua_typename(v)} value")
            return lua_tostring(lv) + lua_tostring(rv)
        if op in ("==", "~="):
            eq = self._lua_eq(lv, rv)
            if not eq and isinstance(lv, LuaTable) \
                    and isinstance(rv, LuaTable):
                # __eq fires only for two tables that are not raw-equal
                h = self._getmeta(lv, "__eq") or self._getmeta(rv, "__eq")
                if h is not None:
                    res = self.call(h, (lv, rv))
                    eq = _truthy(res[0] if res else None)
            return eq if op == "==" else not eq
        if op in ("<", "<=", ">", ">="):
            if isinstance(lv, str) and isinstance(rv, str):
                pass
            elif isinstance(lv, (int, float)) and \
                    isinstance(rv, (int, float)) and \
                    not isinstance(lv, bool) and not isinstance(rv, bool):
                pass
            else:
                # a > b is b < a, a >= b is b <= a (lua 5.4 §3.4.4)
                ev = "__lt" if op in ("<", ">") else "__le"
                a, b = (lv, rv) if op in ("<", "<=") else (rv, lv)
                err = (f"line {line}: attempt to compare "
                       f"{lua_typename(lv)} with {lua_typename(rv)}")
                return _truthy(self._binmeta(ev, a, b, line, err))
            return {"<": lv < rv, "<=": lv <= rv,
                    ">": lv > rv, ">=": lv >= rv}[op]
        if op in ("&", "|", "~", "<<", ">>"):
            try:
                ln = _int_operand(lv, op, line)
                rn = _int_operand(rv, op, line)
            except LuaError as exc:
                events = {"&": "__band", "|": "__bor", "~": "__bxor",
                          "<<": "__shl", ">>": "__shr"}
                return self._binmeta(events[op], lv, rv, line, str(exc))
            if op == "&":
                return _wrap_i64(ln & rn)
            if op == "|":
                return _wrap_i64(ln | rn)
            if op == "~":
                return _wrap_i64(ln ^ rn)
            # shifts are LOGICAL over the 64-bit pattern; counts are
            # signed (negative shifts the other way) and |n| >= 64
            # yields 0 (lua 5.4 §3.4.3)
            if op == ">>":
                rn = -rn
            if rn <= -64 or rn >= 64:
                return 0
            u = ln & (_I64 - 1)
            u = (u << rn) if rn >= 0 else (u >> -rn)
            return _wrap_i64(u)
        try:
            ln = _arith_operand(lv, op, line)
            rn = _arith_operand(rv, op, line)
        except LuaError as exc:
            events = {"+": "__add", "-": "__sub", "*": "__mul",
                      "/": "__div", "//": "__idiv", "%": "__mod",
                      "^": "__pow"}
            return self._binmeta(events[op], lv, rv, line, str(exc))
        if op == "+":
            return ln + rn
        if op == "-":
            return ln - rn
        if op == "*":
            return ln * rn
        if op == "/":
            if rn == 0:
                return _pymath.inf if ln > 0 else (
                    -_pymath.inf if ln < 0 else _pymath.nan)
            return ln / rn
        if op == "//":
            if rn == 0:
                if isinstance(ln, int) and isinstance(rn, int):
                    raise LuaError(
                        f"line {line}: attempt to perform 'n//0'")
                return _pymath.inf if ln > 0 else -_pymath.inf
            return ln // rn
        if op == "%":
            if rn == 0:
                if isinstance(ln, int) and isinstance(rn, int):
                    raise LuaError(
                        f"line {line}: attempt to perform 'n%%0'")
                return _pymath.nan
            return ln - (ln // rn) * rn
        if op == "^":
            return float(ln) ** float(rn)
        raise LuaError(f"unknown operator {op}")   # pragma: no cover

    @staticmethod
    def _lua_eq(a, b) -> bool:
        # no coercion across types; 1 == 1.0 is true (both numbers)
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a == b
        if type(a) is not type(b):
            return False
        if isinstance(a, (str,)):
            return a == b
        return a is b

    # -- stdlib ----------------------------------------------------------
    def _install_stdlib(self) -> None:
        g = self.globals

        def _print(*args):
            self.output("\t".join(self.tostring(a) for a in args))

        def _setmetatable(t, mt=None):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'setmetatable' "
                               "(table expected)")
            if mt is not None and not isinstance(mt, LuaTable):
                raise LuaError("bad argument #2 to 'setmetatable' "
                               "(nil or table expected)")
            if t.metatable is not None and \
                    t.metatable.get("__metatable") is not None:
                raise LuaError("cannot change a protected metatable")
            t.metatable = mt
            return t

        def _getmetatable(t=None):
            if not isinstance(t, LuaTable) or t.metatable is None:
                return None
            protected = t.metatable.get("__metatable")
            return protected if protected is not None else t.metatable

        def _rawequal(a=None, b=None):
            return self._lua_eq(a, b)

        def _rawlen(v=None):
            if isinstance(v, str):
                return len(v)
            if isinstance(v, LuaTable):
                return v.length()
            raise LuaError("table or string expected")

        def _ipairs_iter(t, i):
            i = int(i) + 1
            v = t.get(i)
            if v is None:
                return None
            return (i, v)

        def _pairs_iter(t, key):
            keys = list(t.data.keys())
            if key is None:
                idx = 0
            else:
                try:
                    idx = keys.index(_normkey(key)) + 1
                except ValueError:
                    return None
            if idx >= len(keys):
                return None
            k = keys[idx]
            return (_denormkey(k), t.data[k])

        def _select(which, *rest):
            if which == "#":
                return len(rest)
            return rest[int(which) - 1:] if rest else ()

        def _pcall(fn, *args):
            try:
                return (True,) + self.call(fn, args)
            except LuaError as exc:
                return (False, exc.value)   # the error VALUE, verbatim
            except RecursionError:
                # a host-function chain can still overflow outside
                # call()'s chokepoint; lua 5.4 pcall returns this too
                return (False, "stack overflow")

        def _error(msg, _level=None):
            # the message coerces for uncaught display; the VALUE
            # (table, number, ...) rides .value for pcall to return
            raise LuaError(lua_tostring(msg), value=msg)

        def _assert(v, msg=None, *rest):
            if not _truthy(v):
                if msg is None:
                    raise LuaError("assertion failed!")
                raise LuaError(lua_tostring(msg), value=msg)
            return (v, msg) + rest

        def _unpack(t, i=1, j=None):
            j = t.length() if j is None else int(j)
            return tuple(t.get(k) for k in range(int(i), j + 1))

        g.update({
            "print": _print,
            "type": lambda v=None: lua_typename(v),
            "tostring": lambda v=None: self.tostring(v),
            "setmetatable": _setmetatable,
            "getmetatable": _getmetatable,
            "rawequal": _rawequal,
            "rawlen": _rawlen,
            "tonumber": _tonumber,
            "ipairs": lambda t: (_ipairs_iter, t, 0),
            "pairs": lambda t: (_pairs_iter, t, None),
            "select": _select,
            "pcall": _pcall,
            "error": _error,
            "assert": _assert,
            "unpack": _unpack,
            "rawget": lambda t, k: t.get(k),
            "rawset": lambda t, k, v: (t.set(k, v), t)[1],
            "require": self._require,
        })

        # string ---------------------------------------------------------
        def _fmt_num(a, ai):
            num = _tonumber(a)
            if num is None or isinstance(a, bool):
                raise LuaError(
                    f"bad argument #{ai} to 'format' "
                    f"(number expected, got {lua_typename(a)})")
            return num

        def _fmt(spec, *args):
            out, ai, i, n = [], 0, 0, len(spec)
            while i < n:
                c = spec[i]
                if c != "%":
                    out.append(c)
                    i += 1
                    continue
                j = i + 1
                while j < n and spec[j] in "-+ #0123456789.":
                    j += 1
                if j >= n:
                    raise LuaError("invalid format string")
                conv = spec[j]
                frag = spec[i:j + 1]
                if conv == "%":
                    out.append("%")
                else:
                    a = args[ai] if ai < len(args) else None
                    ai += 1
                    if conv in "diu":
                        out.append((frag[:-1] + "d") % int(_fmt_num(a, ai)))
                    elif conv in "fgGeE":
                        out.append(frag % float(_fmt_num(a, ai)))
                    elif conv in "xX":
                        out.append(frag % int(_fmt_num(a, ai)))
                    elif conv == "c":
                        out.append(chr(int(_fmt_num(a, ai))))
                    elif conv == "q":
                        s = lua_tostring(a)
                        out.append('"' + s.replace("\\", "\\\\")
                                   .replace('"', '\\"')
                                   .replace("\n", "\\n") + '"')
                    elif conv == "s":
                        out.append(frag % lua_tostring(a))
                    else:
                        raise LuaError(
                            f"invalid conversion '%{conv}' to 'format'")
                i = j + 1
            return "".join(out)

        def _sub(s, i, j=-1):
            i, j, ln = int(i), int(j), len(s)
            if i < 0:
                i = max(ln + i + 1, 1)
            elif i == 0:
                i = 1
            if j < 0:
                j = ln + j + 1
            elif j > ln:
                j = ln
            if i > j:
                return ""
            return s[i - 1:j]

        def _find(s, pat, init=1, plain=None):
            # plain-text find only (pattern matching is out of scope)
            start = int(init) - 1 if init > 0 else len(s) + int(init)
            idx = s.find(pat, max(start, 0))
            if idx < 0:
                return None
            return (idx + 1, idx + len(pat))

        def _gsub(s, pat, repl, count=None):
            # plain-text substitution subset
            limit = -1 if count is None else int(count)
            done = 0
            out = s
            if limit < 0:
                out = s.replace(pat, lua_tostring(repl))
                done = s.count(pat)
            else:
                out = s.replace(pat, lua_tostring(repl), limit)
                done = min(s.count(pat), limit)
            return (out, done)

        def _byte(s, i=1, j=None):
            j = i if j is None else j
            seg = _sub(s, i, j)
            return tuple(ord(c) for c in seg)

        g["string"] = LuaTable({
            "format": _fmt,
            "len": lambda s: len(s),
            "sub": _sub,
            "upper": lambda s: s.upper(),
            "lower": lambda s: s.lower(),
            "rep": lambda s, n2, sep=None: (
                (lua_tostring(sep or "")).join([s] * int(n2))
                if n2 > 0 else ""),
            "reverse": lambda s: s[::-1],
            "byte": _byte,
            "char": lambda *cs: "".join(chr(int(c)) for c in cs),
            "find": _find,
            "gsub": _gsub,
        })

        # table ----------------------------------------------------------
        def _tinsert(t, a, b=None):
            if b is None:
                t.set(t.length() + 1, a)
            else:
                pos = int(a)
                for k in range(t.length(), pos - 1, -1):
                    t.set(k + 1, t.get(k))
                t.set(pos, b)

        def _tremove(t, pos=None):
            n = t.length()
            if n == 0:
                return None
            pos = n if pos is None else int(pos)
            v = t.get(pos)
            for k in range(pos, n):
                t.set(k, t.get(k + 1))
            t.set(n, None)
            return v

        def _tconcat(t, sep="", i=1, j=None):
            j = t.length() if j is None else int(j)
            return lua_tostring(sep).join(
                lua_tostring(t.get(k)) for k in range(int(i), j + 1))

        def _tsort(t, cmp=None):
            items = t.to_list()
            if cmp is None:
                items.sort()
            else:
                import functools

                def pycmp(a, b):
                    r = self.call(cmp, (a, b))
                    return -1 if (r and _truthy(r[0])) else 1
                items.sort(key=functools.cmp_to_key(pycmp))
            for idx2, v in enumerate(items):
                t.set(idx2 + 1, v)

        g["table"] = LuaTable({
            "insert": _tinsert,
            "remove": _tremove,
            "concat": _tconcat,
            "sort": _tsort,
            "unpack": _unpack,
        })

        # math -----------------------------------------------------------
        g["math"] = LuaTable({
            "floor": lambda x: int(_pymath.floor(x)),
            "ceil": lambda x: int(_pymath.ceil(x)),
            "abs": lambda x: abs(x),
            "sqrt": lambda x: _pymath.sqrt(x),
            "max": lambda *xs: max(xs),
            "min": lambda *xs: min(xs),
            "fmod": lambda a, b: _pymath.fmod(a, b),
            "huge": _pymath.inf,
            "pi": _pymath.pi,
            "tointeger": lambda x: int(x) if isinstance(x, (int, float))
            and not isinstance(x, bool) and float(x).is_integer() else None,
        })

        # os -------------------------------------------------------------
        g["os"] = LuaTable({
            "time": lambda: int(_pytime.time()),
            "clock": lambda: _pytime.process_time(),
        })

        # coroutine ------------------------------------------------------
        def _co_create(fn):
            if not (isinstance(fn, LuaFunction) or callable(fn)):
                raise LuaError("bad argument #1 to 'create' "
                               f"(function expected, got "
                               f"{lua_typename(fn)})")
            return LuaCoroutine(fn, self)

        def _co_resume(co, *args):
            if not isinstance(co, LuaCoroutine):
                raise LuaError("bad argument #1 to 'resume' "
                               f"(coroutine expected, got "
                               f"{lua_typename(co)})")
            return co.resume(args)

        def _co_yield(*args):
            if not self._co_stack:
                raise LuaError("attempt to yield from outside "
                               "a coroutine")
            return self._co_stack[-1].yield_(args)

        def _co_status(co):
            if not isinstance(co, LuaCoroutine):
                raise LuaError("bad argument #1 to 'status' "
                               f"(coroutine expected, got "
                               f"{lua_typename(co)})")
            if co is self._main_co:
                return "normal" if self._co_stack else "running"
            return co.status

        def _co_wrap(fn):
            co = _co_create(fn)

            def _wrapped(*args):
                out = co.resume(args)
                if not out[0]:
                    # re-raise with the ORIGINAL error value: an outer
                    # pcall around a wrapped coroutine must return the
                    # body's error(tbl) table verbatim, not a string
                    raise LuaError(lua_tostring(out[1]), value=out[1])
                return out[1:]
            return _wrapped

        def _co_close(co):
            if not isinstance(co, LuaCoroutine):
                raise LuaError("bad argument #1 to 'close' "
                               f"(coroutine expected, got "
                               f"{lua_typename(co)})")
            if co.status in ("running", "normal"):
                return (False, "cannot close a "
                        f"{co.status} coroutine")
            if not co.close():   # unwinds a parked body; thread exits
                return (False, "cannot close coroutine: body thread "
                        "did not exit (a host frame swallowed the "
                        "close signal)")
            return True

        g["coroutine"] = LuaTable({
            "create": _co_create,
            "resume": _co_resume,
            "yield": _co_yield,
            "status": _co_status,
            "wrap": _co_wrap,
            "close": _co_close,
            "isyieldable": lambda: bool(self._co_stack),
            "running": lambda: (
                (self._co_stack[-1], False) if self._co_stack
                else (self._main_co, True)),
        })

    def _require(self, name):
        if name in self.modules:
            return self.modules[name]
        raise LuaError(f"module '{lua_tostring(name)}' not found "
                       "(only host-registered modules are loadable)")
