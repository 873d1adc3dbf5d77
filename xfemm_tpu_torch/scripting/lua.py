"""A small Lua interpreter for FEMM automation scripts.

The reference drives batch analyses through Lua 4.0 embedded in femmcli
(cfemm/libfemm/LuaInstance.h:48; command tables in
cfemm/femmcli/Lua*Commands.cpp). Scripts are overwhelmingly imperative
glue -- assignments, arithmetic, numeric for loops, functions, tables,
string concatenation -- around the mi_*/mo_*/hi_*/ho_*/ei_*/eo_* verbs.
This module implements that Lua subset from scratch (lexer, Pratt
parser, tree-walking evaluator) and binds the verb table from
:mod:`xfemm_tpu_torch.femm_compat`, so existing femmcli scripts run
unmodified:

    from xfemm_tpu_torch.scripting import lua
    lua.run_file("femmcli_TorqueBenchmark.lua")

Supported language (the Lua-4.0 flavor the FEMM scripts use):
  - numbers, strings, nil; tables (array/hash), nested indexing
  - operators: + - * / ^ %  .. == ~= < <= > >= and or not unary-
    (comparisons return 1/nil like Lua 4; and/or short-circuit)
  - statements: assignment (incl. multiple `a, b = f()`), local,
    if/elseif/else, numeric for, `for k,v in t`-less (not used), while,
    repeat/until, break, return, function definitions (incl. varargs-
    free named functions), do blocks
  - stdlib: print, tostring, tonumber, format, strlen/strsub/strfind*,
    floor/ceil/abs/min/max/sqrt/exp/log/log10, trig in degrees like
    FEMM's mathlib (sin/cos/tan/asin/acos/atan/atan2), PI, date-less
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["LuaError", "Interpreter", "run_file", "run_string"]


class LuaError(Exception):
    pass


# --------------------------------------------------------------------- #
# lexer                                                                 #
# --------------------------------------------------------------------- #
_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>\.\.|==|~=|<=|>=|[-+*/^%<>=(){}\[\];,.:#])
""", re.VERBOSE)

_KEYWORDS = {"and", "break", "do", "else", "elseif", "end", "for",
             "function", "if", "in", "local", "nil", "not", "or",
             "repeat", "return", "then", "until", "while"}


@dataclass
class Tok:
    kind: str     # number | name | string | op | kw | eof
    value: Any
    line: int


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "'": "'", "\\": "\\"}.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(src: str) -> list[Tok]:
    toks: list[Tok] = []
    line = 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise LuaError(f"lexical error at line {line}: "
                           f"{src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        line += text.count("\n")
        if kind in ("ws", "comment"):
            continue
        if kind == "number":
            toks.append(Tok("number", float(text), line))
        elif kind == "name":
            if text in _KEYWORDS:
                toks.append(Tok("kw", text, line))
            else:
                toks.append(Tok("name", text, line))
        elif kind == "string":
            toks.append(Tok("string", _unescape(text[1:-1]), line))
        else:
            toks.append(Tok("op", text, line))
    toks.append(Tok("eof", None, line))
    return toks


# --------------------------------------------------------------------- #
# parser -- produces a nested-tuple AST                                 #
# --------------------------------------------------------------------- #
class Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, value=None):
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Tok:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise LuaError(f"line {t.line}: expected "
                           f"{value or kind}, got {t.value!r}")
        return t

    # ---------------- statements ---------------- #
    def parse_chunk(self, terminators=("eof",)):
        stmts = []
        while True:
            t = self.peek()
            if t.kind == "eof" or (t.kind == "kw" and t.value in
                                   terminators):
                return ("block", stmts)
            s = self.parse_statement()
            if s is not None:
                stmts.append(s)

    def parse_statement(self):
        if self.accept("op", ";"):
            return None
        t = self.peek()
        if t.kind == "kw":
            if t.value == "if":
                return self.parse_if()
            if t.value == "while":
                return self.parse_while()
            if t.value == "repeat":
                return self.parse_repeat()
            if t.value == "for":
                return self.parse_for()
            if t.value == "function":
                return self.parse_function_stmt()
            if t.value == "local":
                return self.parse_local()
            if t.value == "return":
                self.next()
                nxt = self.peek()
                if nxt.kind == "eof" or (nxt.kind == "kw" and nxt.value in
                                         ("end", "else", "elseif",
                                          "until")):
                    return ("return", [])
                return ("return", self.parse_exprlist())
            if t.value == "break":
                self.next()
                return ("break",)
            if t.value == "do":
                self.next()
                body = self.parse_chunk(("end",))
                self.expect("kw", "end")
                return body
        # expression statement: call or assignment
        e = self.parse_prefixexpr()
        if self.peek().kind == "op" and self.peek().value in (",", "="):
            targets = [e]
            while self.accept("op", ","):
                targets.append(self.parse_prefixexpr())
            self.expect("op", "=")
            values = self.parse_exprlist()
            return ("assign", targets, values)
        if e[0] not in ("call", "method"):
            raise LuaError(f"line {t.line}: syntax error near "
                           f"{self.peek().value!r}")
        return ("exprstat", e)

    def parse_if(self):
        self.expect("kw", "if")
        cond = self.parse_expr()
        self.expect("kw", "then")
        body = self.parse_chunk(("end", "else", "elseif"))
        clauses = [(cond, body)]
        orelse = ("block", [])
        while True:
            t = self.next()
            if t.kind == "kw" and t.value == "elseif":
                c = self.parse_expr()
                self.expect("kw", "then")
                b = self.parse_chunk(("end", "else", "elseif"))
                clauses.append((c, b))
            elif t.kind == "kw" and t.value == "else":
                orelse = self.parse_chunk(("end",))
                self.expect("kw", "end")
                break
            elif t.kind == "kw" and t.value == "end":
                break
            else:
                raise LuaError(f"line {t.line}: malformed if")
        return ("if", clauses, orelse)

    def parse_while(self):
        self.expect("kw", "while")
        cond = self.parse_expr()
        self.expect("kw", "do")
        body = self.parse_chunk(("end",))
        self.expect("kw", "end")
        return ("while", cond, body)

    def parse_repeat(self):
        self.expect("kw", "repeat")
        body = self.parse_chunk(("until",))
        self.expect("kw", "until")
        cond = self.parse_expr()
        return ("repeat", body, cond)

    def parse_for(self):
        self.expect("kw", "for")
        var = self.expect("name").value
        self.expect("op", "=")
        start = self.parse_expr()
        self.expect("op", ",")
        stop = self.parse_expr()
        step = None
        if self.accept("op", ","):
            step = self.parse_expr()
        self.expect("kw", "do")
        body = self.parse_chunk(("end",))
        self.expect("kw", "end")
        return ("fornum", var, start, stop, step, body)

    def parse_function_stmt(self):
        t = self.expect("kw", "function")
        name = self.expect("name").value
        params, body = self.parse_funcbody()
        return ("assign", [("name", name)],
                [("function", params, body, t.line, name)])

    def parse_funcbody(self):
        self.expect("op", "(")
        params = []
        if not self.accept("op", ")"):
            while True:
                params.append(self.expect("name").value)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        body = self.parse_chunk(("end",))
        self.expect("kw", "end")
        return params, body

    def parse_local(self):
        self.expect("kw", "local")
        if self.accept("kw", "function"):
            name = self.expect("name").value
            params, body = self.parse_funcbody()
            return ("localassign", [name],
                    [("function", params, body, self.peek().line, name)])
        names = [self.expect("name").value]
        while self.accept("op", ","):
            names.append(self.expect("name").value)
        values = []
        if self.accept("op", "="):
            values = self.parse_exprlist()
        return ("localassign", names, values)

    # ---------------- expressions ---------------- #
    _BINPREC = {"or": 1, "and": 2,
                "<": 3, ">": 3, "<=": 3, ">=": 3, "==": 3, "~=": 3,
                "..": 4, "+": 5, "-": 5, "*": 6, "/": 6, "%": 6,
                "^": 8}

    def parse_exprlist(self):
        out = [self.parse_expr()]
        while self.accept("op", ","):
            out.append(self.parse_expr())
        return out

    def parse_expr(self, limit=0):
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            left = ("neg", self.parse_expr(7))
        elif t.kind == "kw" and t.value == "not":
            self.next()
            left = ("not", self.parse_expr(7))
        else:
            left = self.parse_simpleexpr()
        while True:
            t = self.peek()
            op = t.value if (t.kind == "op" or
                             (t.kind == "kw" and t.value in
                              ("and", "or"))) else None
            prec = self._BINPREC.get(op)
            if prec is None or prec <= limit:
                return left
            self.next()
            # right associativity for ^ and ..
            sub = prec - 1 if op in ("^", "..") else prec
            right = self.parse_expr(sub)
            left = ("binop", op, left, right)

    def parse_simpleexpr(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("const", t.value)
        if t.kind == "string":
            self.next()
            return ("const", t.value)
        if t.kind == "kw" and t.value == "nil":
            self.next()
            return ("const", None)
        if t.kind == "kw" and t.value == "function":
            self.next()
            params, body = self.parse_funcbody()
            return ("function", params, body, t.line)
        if t.kind == "op" and t.value == "{":
            return self.parse_table()
        return self.parse_prefixexpr()

    def parse_table(self):
        self.expect("op", "{")
        items = []   # ("item", expr) | ("field", key-const, expr)
        while not self.accept("op", "}"):
            t = self.peek()
            if t.kind == "op" and t.value == "[":
                self.next()
                k = self.parse_expr()
                self.expect("op", "]")
                self.expect("op", "=")
                items.append(("field", k, self.parse_expr()))
            elif (t.kind == "name"
                  and self.toks[self.i + 1].kind == "op"
                  and self.toks[self.i + 1].value == "="):
                self.next()
                self.next()
                items.append(("field", ("const", t.value),
                              self.parse_expr()))
            else:
                items.append(("item", self.parse_expr()))
            if not (self.accept("op", ",") or self.accept("op", ";")):
                self.expect("op", "}")
                break
        return ("table", items)

    def parse_prefixexpr(self):
        t = self.next()
        if t.kind == "name":
            e = ("name", t.value)
        elif t.kind == "op" and t.value == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            e = ("paren", e)
        else:
            raise LuaError(f"line {t.line}: unexpected {t.value!r}")
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                self.next()
                k = self.expect("name").value
                e = ("index", e, ("const", k))
            elif t.kind == "op" and t.value == "[":
                self.next()
                k = self.parse_expr()
                self.expect("op", "]")
                e = ("index", e, k)
            elif t.kind == "op" and t.value == "(":
                self.next()
                args = []
                if not self.accept("op", ")"):
                    args = self.parse_exprlist()
                    self.expect("op", ")")
                e = ("call", e, args, t.line)
            elif t.kind == "string":
                self.next()
                e = ("call", e, [("const", t.value)], t.line)
            else:
                return e


# --------------------------------------------------------------------- #
# evaluator                                                             #
# --------------------------------------------------------------------- #
class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


class LuaFunction:
    def __init__(self, params, body, interp, def_line: int = 0):
        self.params = params
        self.body = body
        self.interp = interp
        self.def_line = def_line

    def __call__(self, *args):
        scope = dict(zip(self.params,
                         list(args) + [None] * (len(self.params)
                                                - len(args))))
        self.interp._locals.append(scope)
        try:
            self.interp.exec_block(self.body)
            return ()
        except _Return as r:
            return tuple(r.values)
        finally:
            self.interp._locals.pop()


def _num_to_str(v: float) -> str:
    # Lua's default tostring for numbers (%.14g, integers bare)
    if math.isfinite(v) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return "%.14g" % v


def _tostr(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, float):
        return _num_to_str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, complex):
        # femmcomplex.cpp formatting: "re", "re+I", "re-I", "re+I*im"
        re_s = _num_to_str(v.real)
        if v.imag == 0:
            return re_s
        if v.imag == 1:
            return re_s + "+I"
        if v.imag == -1:
            return re_s + "-I"
        if v.imag > 0:
            return re_s + "+I*" + _num_to_str(v.imag)
        return re_s + "-I*" + _num_to_str(-v.imag)
    return str(v)


def _tonum(v):
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


class Interpreter:
    """One Lua execution environment bound to the femm_compat verbs."""

    def __init__(self, bind_femm: bool = True,
                 output: Callable[[str], None] | None = None,
                 trace_calls: bool = False, pedantic: bool = False,
                 script_path: str = "<string>", device=None,
                 hbm_bytes: float | None = None):
        self.globals: dict[str, Any] = {}
        self._locals: list[dict] = []
        self.output = output or (lambda s: print(s))
        #: call-stack frames for trace()/--lua-trace-functions
        #: (LuaInstance.cpp:302 luaTrace / :128 call-hook equivalents):
        #: [name, def_line, cur_line] with "main" at the bottom
        self.frames: list[list] = [["main", 0, 0]]
        self.trace_calls = trace_calls
        self.pedantic = pedantic
        self.script_path = script_path
        self._install_stdlib()
        if bind_femm:
            # the documents a script opens take the interpreter's device
            # and planner memory: a script cannot name them itself
            self._install_femm(device, hbm_bytes)
            # femmcli auto-loads release/init.lua on every invocation
            # (main.cpp:125 locateFile): predefine the same constants
            # (uo, eo, unit factors), AWG, draw helpers and *_makeABC
            from . import initenv
            initenv.install(self.globals)

    # ------------------------- environments ------------------------- #
    def get_var(self, name):
        for scope in reversed(self._locals):
            if name in scope:
                return scope[name]
        v = self.globals.get(name)
        if v is None and self.pedantic and not name.startswith("_"):
            self.output(f"WARNING: access to undefined variable {name!r}")
        if v is None and "_" in name:
            # femmcli registers every verb under two spellings
            # (mi_addnode / mi_add_node, showconsole / show_console);
            # fall back to the compact form
            m = re.match(r"^(m|e|h)(i|o)_(.+)$", name)
            if m:
                alt = f"{m.group(1)}{m.group(2)}_" + \
                    m.group(3).replace("_", "")
            else:
                alt = name.replace("_", "")
            v = self.globals.get(alt)
        return v

    def set_var(self, name, value):
        for scope in reversed(self._locals):
            if name in scope:
                scope[name] = value
                return
        self.globals[name] = value

    # ------------------------- libraries ---------------------------- #
    def _install_stdlib(self):
        g = self.globals

        def lprint(*args):
            self.output("\t".join(_tostr(a) for a in args))

        g["print"] = lprint
        g["tostring"] = _tostr
        g["tonumber"] = _tonum
        g["format"] = lambda fmt, *a: _lua_format(fmt, a)
        g["strlen"] = lambda s: float(len(s))
        g["strsub"] = lambda s, i, j=-1.0: s[int(i) - 1:
                                             int(j) if j >= 0 else None]
        g["strlower"] = lambda s: s.lower()
        g["strupper"] = lambda s: s.upper()
        g["abs"] = lambda x: abs(x)
        g["ceil"] = lambda x: float(math.ceil(x))
        g["floor"] = lambda x: float(math.floor(x))
        g["sqrt"] = lambda x: math.sqrt(x)
        g["exp"] = lambda x: math.exp(x)
        g["log"] = lambda x: math.log(x)
        g["log10"] = lambda x: math.log10(x)
        g["min"] = lambda *a: min(a)
        g["max"] = lambda *a: max(a)
        g["mod"] = lambda a, b: math.fmod(a, b)
        # FEMM's lua math is in DEGREES (femm42 mathlib convention)
        g["sin"] = lambda x: math.sin(math.radians(x))
        g["cos"] = lambda x: math.cos(math.radians(x))
        g["tan"] = lambda x: math.tan(math.radians(x))
        g["asin"] = lambda x: math.degrees(math.asin(x))
        g["acos"] = lambda x: math.degrees(math.acos(x))
        g["atan"] = lambda x: math.degrees(math.atan(x))
        g["atan2"] = lambda y, x: math.degrees(math.atan2(y, x))
        g["PI"] = math.pi
        g["getn"] = lambda t: float(_table_n(t))
        g["tinsert"] = _tinsert
        g["Complex"] = lambda re=0.0, im=0.0: complex(re, im)
        g["Re"] = lambda z: z.real if isinstance(z, complex) else z
        g["Im"] = lambda z: z.imag if isinstance(z, complex) else 0.0
        g["femmVersion"] = lambda: 42.0

        def _trace(bt=None):
            # stack backtrace like LuaInstance::luaStackInfo
            # (LuaInstance.cpp:318): one frame by default, the full
            # stack for trace(1)
            frames = self.frames if (bt is not None and bt != 0) \
                else self.frames[-1:]
            for fr in reversed(frames):
                name, def_line, cur_line = fr
                label = "main" if name == "main" \
                    else f"global Lua {name}()"
                self.output(f"L{int(cur_line):<9d} {label} "
                            f"[{self.script_path}:{int(def_line)}]")

        g["trace"] = _trace
        # FEMM-4.2 quirk-emulation toggle (LuaInstance.h:131): the state
        # round-trips; commands with divergent 4.0/4.1 semantics are not
        # emulated (the reference likewise raises "not implemented")
        self.compat_mode = 0

        def _setcompat(v=0.0):
            self.compat_mode = int(v)

        g["setcompatibilitymode"] = _setcompat
        g["getcompatibilitymode"] = lambda: float(self.compat_mode)
        g["clearconsole"] = lambda *a: None
        g["showconsole"] = lambda *a: None
        g["messagebox"] = lambda *a: self.output(
            " ".join(_tostr(x) for x in a))
        g["pause"] = lambda *a: None
        g["quit"] = lambda *a: None

        def lassert(v, msg=None):
            if not _truthy(v):
                raise LuaError(msg or "assertion failed!")
            return v

        g["assert"] = lassert

        import os as _os

        g["chdir"] = lambda p: (_os.chdir(p), None)[1]
        g["getcwd"] = lambda: _os.getcwd()
        g["openfile"] = _openfile
        g["closefile"] = lambda fh: (fh.close(), None)[1] if fh else None
        g["remove"] = lambda p: (_os.remove(p), None)[1]
        g["read"] = lambda fh, fmt="*l": _luaread(fh, fmt)
        g["date"] = lambda fmt=None: __import__("time").strftime(
            fmt or "%c")
        g["write"] = lambda *a: self.output(
            "".join(_tostr(x) for x in a).rstrip("\n"))
        g["exit"] = lambda *a: (_ for _ in ()).throw(_Return([]))

    def _install_femm(self, device, hbm_bytes):
        import functools

        from .. import femm_compat
        for name in ("newdocument", "opendocument", "mi_newdocument",
                     "hi_newdocument", "ei_newdocument"):
            self.globals[name] = _wrap_femm(functools.partial(
                getattr(femm_compat, name), device=device,
                hbm_bytes=hbm_bytes))
        for name in dir(femm_compat):
            if name.startswith("_"):
                continue
            fn = getattr(femm_compat, name)
            if callable(fn):
                self.globals.setdefault(name, _wrap_femm(fn))
        # femm lua's document verbs (femm42 Lua names)
        self.globals.setdefault("open", self.globals["opendocument"])
        # femmcli aliases with underscores (mi_add_node etc.)
        for name in list(self.globals):
            m = re.match(r"^(m|e|h)(i|o)_([a-z0-9]+)$", name)
            if m:
                pass

    # ------------------------- execution ---------------------------- #
    def run(self, src: str):
        ast = Parser(tokenize(src)).parse_chunk()
        try:
            self.exec_block(ast)
        except _Return:
            pass

    def exec_block(self, block):
        for stmt in block[1]:
            self.exec_stmt(stmt)

    def exec_stmt(self, s):
        op = s[0]
        if op == "assign":
            values = self._eval_list(s[2], len(s[1]))
            for tgt, v in zip(s[1], values):
                if tgt[0] == "name":
                    self.set_var(tgt[1], v)
                elif tgt[0] == "index":
                    table = self.eval(tgt[1])
                    if not isinstance(table, dict):
                        raise LuaError("indexing a non-table value")
                    table[_normkey(self.eval(tgt[2]))] = v
                else:
                    raise LuaError("bad assignment target")
        elif op == "localassign":
            values = self._eval_list(s[2], len(s[1]))
            scope = self._locals[-1] if self._locals else self.globals
            for n, v in zip(s[1], values):
                scope[n] = v
        elif op == "exprstat":
            self.eval(s[1])
        elif op == "if":
            for cond, body in s[1]:
                if _truthy(self.eval(cond)):
                    self.exec_block(body)
                    return
            self.exec_block(s[2])
        elif op == "while":
            while _truthy(self.eval(s[1])):
                try:
                    self.exec_block(s[2])
                except _Break:
                    break
        elif op == "repeat":
            while True:
                try:
                    self.exec_block(s[1])
                except _Break:
                    break
                if _truthy(self.eval(s[2])):
                    break
        elif op == "fornum":
            start = self.eval(s[2])
            stop = self.eval(s[3])
            step = self.eval(s[4]) if s[4] is not None else 1.0
            v = start
            while (step > 0 and v <= stop + 1e-12) or \
                  (step < 0 and v >= stop - 1e-12):
                self._locals.append({s[1]: v})
                try:
                    self.exec_block(s[5])
                except _Break:
                    self._locals.pop()
                    break
                self._locals.pop()
                v += step
        elif op == "return":
            raise _Return([self.eval(e) for e in s[1]])
        elif op == "break":
            raise _Break()
        elif op == "block":
            self.exec_block(s)
        else:
            raise LuaError(f"unknown statement {op}")

    def _eval_list(self, exprs, want):
        """Evaluate an expression list, expanding a trailing call's
        multiple returns (Lua semantics for a, b = f())."""
        values = []
        for i, e in enumerate(exprs):
            v = self.eval(e, expand=(i == len(exprs) - 1))
            if isinstance(v, tuple):
                values.extend(v)
            else:
                values.append(v)
        while len(values) < want:
            values.append(None)
        return values

    def eval(self, e, expand=False):
        op = e[0]
        if op == "const":
            return e[1]
        if op == "name":
            return self.get_var(e[1])
        if op == "paren":
            v = self.eval(e[1])
            return v[0] if isinstance(v, tuple) and v else v
        if op == "neg":
            return -self.eval(e[1])
        if op == "not":
            return None if _truthy(self.eval(e[1])) else 1.0
        if op == "binop":
            return self._binop(e[1], e[2], e[3])
        if op == "index":
            t = self.eval(e[1])
            if not isinstance(t, dict):
                raise LuaError("indexing a non-table value")
            return t.get(_normkey(self.eval(e[2])))
        if op == "call":
            fn = self.eval(e[1])
            if fn is None:
                raise LuaError(f"attempt to call a nil value "
                               f"({_exprname(e[1])})")
            if len(e) > 3:
                self.frames[-1][2] = e[3]     # current line of this frame
            if self.trace_calls:
                kind = "Lua" if isinstance(fn, LuaFunction) else "C"
                line = e[3] if len(e) > 3 else 0
                self.output(f"L{int(line):<9d}       call global {kind} "
                            f"{_exprname(e[1])}() [{self.script_path}]")
            args = []
            for i, a in enumerate(e[2]):
                v = self.eval(a, expand=(i == len(e[2]) - 1))
                if isinstance(v, tuple):
                    args.extend(v)
                else:
                    args.append(v)
            if isinstance(fn, LuaFunction):
                self.frames.append([_exprname(e[1]), fn.def_line, 0])
                try:
                    out = fn(*args)
                finally:
                    self.frames.pop()
            else:
                out = fn(*args)
            if isinstance(out, tuple):
                if expand:
                    return out
                return out[0] if out else None
            return out
        if op == "function":
            return LuaFunction(e[1], e[2], self,
                               def_line=e[3] if len(e) > 3 else 0)
        if op == "table":
            t: dict = {}
            n = 1
            for item in e[1]:
                if item[0] == "item":
                    t[float(n)] = self.eval(item[1])
                    n += 1
                else:
                    t[_normkey(self.eval(item[1]))] = self.eval(item[2])
            return t
        raise LuaError(f"unknown expression {op}")

    def _binop(self, op, le, re_):
        if op == "and":
            l = self.eval(le)
            return self.eval(re_) if _truthy(l) else l
        if op == "or":
            l = self.eval(le)
            return l if _truthy(l) else self.eval(re_)
        l = self.eval(le)
        r = self.eval(re_)
        if op == "..":
            return _tostr(l) + _tostr(r)
        if op == "==":
            return 1.0 if l == r else None
        if op == "~=":
            return 1.0 if l != r else None
        if op in ("<", "<=", ">", ">="):
            res = {"<": l < r, "<=": l <= r,
                   ">": l > r, ">=": l >= r}[op]
            return 1.0 if res else None
        ln = _arith(l)
        rn = _arith(r)
        if op == "+":
            return ln + rn
        if op == "-":
            return ln - rn
        if op == "*":
            return ln * rn
        if op == "/":
            # IEEE semantics like Lua's C doubles: x/0 is +-inf, 0/0 nan
            try:
                return ln / rn
            except ZeroDivisionError:
                if isinstance(ln, complex) or isinstance(rn, complex):
                    return complex("nan")
                if ln == 0:
                    return math.nan
                return math.copysign(math.inf, ln) * \
                    (1.0 if rn == 0 and not math.copysign(1, rn) < 0
                     else 1.0)
        if op == "%":
            try:
                return math.fmod(ln, rn)
            except (ZeroDivisionError, ValueError):
                return math.nan
        if op == "^":
            return ln ** rn
        raise LuaError(f"unknown operator {op}")


def _arith(v):
    if isinstance(v, (int, float, complex)):
        return v
    n = _tonum(v)
    if n is None:
        raise LuaError(f"arithmetic on non-number {v!r}")
    return n


def _truthy(v) -> bool:
    return v is not None and v is not False


def _normkey(k):
    if isinstance(k, float) and k == int(k):
        return float(k)
    return k


def _table_n(t: dict) -> int:
    n = 0
    while float(n + 1) in t:
        n += 1
    return n


def _tinsert(t, *args):
    if len(args) == 1:
        t[float(_table_n(t) + 1)] = args[0]
    else:
        pos = int(args[0])
        for i in range(_table_n(t), pos - 1, -1):
            t[float(i + 1)] = t[float(i)]
        t[float(pos)] = args[1]


def _lua_format(fmt, args):
    out = []
    ai = 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            m = re.match(r"%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGqcs%]",
                         fmt[i:])
            if m:
                spec = m.group()
                if spec == "%%":
                    out.append("%")
                else:
                    a = args[ai]
                    ai += 1
                    if spec[-1] in "diouxX":
                        a = int(a)
                    elif spec[-1] == "q":
                        spec = spec[:-1] + "s"
                        a = '"%s"' % a
                    elif spec[-1] == "s":
                        a = _tostr(a)
                    out.append(spec % a)
                i += m.end()
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _openfile(path, mode="r"):
    try:
        return open(path, mode)
    except OSError:
        return None


def _luaread(fh, fmt="*l"):
    if fmt == "*a":
        return fh.read()
    if fmt == "*n":
        line = fh.readline()
        try:
            return float(line)
        except ValueError:
            return None
    line = fh.readline()
    if not line:
        return None
    return line.rstrip("\n")


def _wrap_femm(fn):
    """femm_compat functions take/return Python floats and tuples; Lua
    passes floats and expects tuples expanded as multiple returns."""
    def wrapped(*args):
        out = fn(*args)
        if isinstance(out, list):
            return tuple(out)
        return out
    return wrapped


def _exprname(e):
    return e[1] if e[0] == "name" else "?"


def run_string(src: str, **kw) -> Interpreter:
    interp = Interpreter(**kw)
    interp.run(src)
    return interp


def run_file(path: str, **kw) -> Interpreter:
    with open(path) as f:
        src = f.read()
    kw.setdefault("script_path", path)
    return run_string(src, **kw)
