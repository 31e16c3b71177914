"""microwasm — a minimal WebAssembly (MVP) interpreter for the CLI host.

The reference embeds a WasmEdge VM with splinter.get/set host functions and
the SIMD proposal enabled (splinter_cli_cmd_wasm.c:85-143).  This image has
no wasm runtime, so the host executes binary modules with a from-scratch
interpreter covering the MVP core:

  sections    type, import, function, table, memory, global, export, start,
              elem, code, data (+ custom, skipped)
  control     block, loop, if/else, br, br_if, br_table, return, call,
              call_indirect
  parametric  drop, select
  variables   local.get/set/tee, global.get/set
  memory      all i32/i64/f32/f64 loads & stores (incl. 8/16/32 partial
              widths), memory.size, memory.grow; bulk memory
              (memory.copy/fill/init, data.drop, passive data segments
              — modern clang --target=wasm32 emits these by default)
  tables      funcref table 0 end to end: the full elem-segment flag
              matrix (active/passive/declared, index- or
              expr-encoded), table.get/set, table.init/copy/grow/
              size/fill + elem.drop, and the funcref ops
              ref.null/ref.is_null/ref.func (null = -1 in the
              unityped interpreter)
  misc        the 0xFC saturating float->int truncation matrix
              (i32/i64.trunc_sat_f32/f64_s/u)
  numeric     full i32/i64 ALU (clz..rotr), f32/f64 arithmetic & compares,
              the conversion/reinterpret matrix, sign-extension ops
  simd        the fixed-width SIMD proposal's v128 core (the reference
              enables the proposal in WasmEdge,
              splinter_cli_cmd_wasm.c:85-143): loads/stores incl. lane +
              splat + extend variants, const/shuffle/swizzle, splats,
              lane extract/replace, ALL lane comparisons, bitwise +
              bitselect + any/all_true + bitmask, integer lane
              add/sub/mul/abs/neg/min/max/shifts/saturating/avgr/dot/
              narrow/extend, float lane
              arith/sqrt/rounding/min/max/pmin/pmax, and the
              int<->float conversion matrix

  multi-value  functions and block signatures returning/carrying
              multiple values (type-index blocktypes; branches to a
              loop carry its params back to the top)

Out of scope (raise WasmError): threads, externref / multiple tables,
and the SIMD tail that exists for codec inner loops (q15mulr,
extadd_pairwise, extmul, relaxed-simd).
Scripts that heavy-compute belong in the JAX tier; wasm here is a
portable *protocol* client, like the reference's.

Host functions are supplied as a dict {("module","name"): python_callable};
callables receive (Instance, *args) so they can touch linear memory.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


class WasmError(Exception):
    pass


class Trap(WasmError):
    pass


MAGIC = b"\x00asm\x01\x00\x00\x00"
PAGE = 65536

I32, I64, F32, F64, V128 = 0x7F, 0x7E, 0x7D, 0x7C, 0x7B
_VALNAMES = {I32: "i32", I64: "i64", F32: "f32", F64: "f64",
             V128: "v128"}


# -------------------------------------------------------------- byte reader

class _Reader:
    __slots__ = ("b", "p")

    def __init__(self, b: bytes, p: int = 0):
        self.b = b
        self.p = p

    def u8(self) -> int:
        v = self.b[self.p]
        self.p += 1
        return v

    def bytes_(self, n: int) -> bytes:
        v = self.b[self.p:self.p + n]
        if len(v) < n:
            raise WasmError("truncated module")
        self.p += n
        return v

    def uleb(self) -> int:
        out = shift = 0
        while True:
            byte = self.u8()
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7

    def sleb(self, bits: int) -> int:
        out = shift = 0
        while True:
            byte = self.u8()
            out |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                if shift < bits and (byte & 0x40):
                    out |= -(1 << shift)
                return out

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes_(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.bytes_(8))[0]

    def name(self) -> str:
        return self.bytes_(self.uleb()).decode("utf-8")

    def eof(self) -> bool:
        return self.p >= len(self.b)


# ------------------------------------------------------------- module model

@dataclass
class FuncType:
    params: tuple
    results: tuple


@dataclass
class Function:
    type: FuncType
    locals: list
    body: list           # decoded instruction list
    name: str = "?"


@dataclass
class Module:
    types: list = field(default_factory=list)
    imports: list = field(default_factory=list)   # (mod, name, kind, extra)
    funcs: list = field(default_factory=list)     # local funcs
    n_imported_funcs: int = 0
    table_min: int = 0
    table_max: Optional[int] = None
    # every elem segment in index order, for table.init/elem.drop:
    # ("active", offset, [funcidx]) | ("passive", None, [funcidx]) |
    # ("declared", None, [funcidx]) — active ones are applied to the
    # table then implicitly dropped at instantiation, declared ones
    # exist only to forward-declare ref.func targets and start dropped
    # (bulk-memory/reference-types spec).  null refs are -1.
    elemsegs: list = field(default_factory=list)
    mem_min: int = 0
    mem_max: Optional[int] = None
    globals: list = field(default_factory=list)   # (valtype, mutable, init)
    exports: dict = field(default_factory=dict)   # name -> (kind, idx)
    start: Optional[int] = None
    data: list = field(default_factory=list)      # active: (offset, bytes)
    # every data segment in index order, for memory.init/data.drop:
    # ("active"|"passive", bytes) — active ones are implicitly dropped
    # after instantiation (bulk-memory spec)
    datasegs: list = field(default_factory=list)


def _decode_valtype(r: _Reader) -> int:
    t = r.u8()
    if t not in _VALNAMES:
        raise WasmError(f"unsupported value type 0x{t:02x}")
    return t


def _decode_blocktype(r: _Reader, types=None) -> tuple:
    """(params, results) valtype tuples.  Three encodings (wasm 1.1 /
    multi-value): 0x40 = empty, a single valtype byte = one result, or
    a non-negative s33 = index into the type section (full signature,
    params enter the block on the stack)."""
    t = r.b[r.p]
    if t == 0x40:
        r.p += 1
        return ((), ())
    if t in _VALNAMES:
        r.p += 1
        return ((), (t,))
    if t >= 0x80 or t < 0x40:      # non-negative s33 -> type index
        idx = r.uleb()
        if types is None or idx >= len(types):
            raise WasmError(f"blocktype type index {idx} out of range")
        ft = types[idx]
        return (ft.params, ft.results)
    raise WasmError(f"bad blocktype 0x{t:02x}")


# ------------------------------------------------------------- SIMD tables
# v128 values travel the stack as 16-byte `bytes`; lane math runs on numpy
# views.  Tables key the fixed-width SIMD proposal's sub-opcodes (0xFD
# prefix) to (dtype, operation) pairs so the executor stays a dispatch.

_SD = {0: "<i1", 1: "<i2", 2: "<i4", 3: "<i8"}   # signed by log2 width
_UD = {0: "<u1", 1: "<u2", 2: "<u4", 3: "<u8"}

_SIMD_CMP: dict[int, tuple[str, str]] = {}
for _b, _w in ((35, 0), (45, 1), (55, 2)):
    for _j, _dt in enumerate((_SD[_w], _SD[_w], _SD[_w], _UD[_w],
                              _SD[_w], _UD[_w], _SD[_w], _UD[_w],
                              _SD[_w], _UD[_w])):
        _SIMD_CMP[_b + _j] = (_dt, ("eq", "ne", "lt", "lt", "gt", "gt",
                                    "le", "le", "ge", "ge")[_j])
for _b, _dt in ((65, "<f4"), (71, "<f8")):
    for _j, _nm in enumerate(("eq", "ne", "lt", "gt", "le", "ge")):
        _SIMD_CMP[_b + _j] = (_dt, _nm)
for _j, _nm in enumerate(("eq", "ne", "lt", "gt", "le", "ge")):
    _SIMD_CMP[214 + _j] = ("<i8", _nm)

_SIMD_IBIN = {  # wrap-around + saturating + min/max/avgr integer binops
    110: ("<u1", "add"), 113: ("<u1", "sub"),
    142: ("<u2", "add"), 145: ("<u2", "sub"), 149: ("<u2", "mul"),
    174: ("<u4", "add"), 177: ("<u4", "sub"), 181: ("<u4", "mul"),
    206: ("<u8", "add"), 209: ("<u8", "sub"), 213: ("<u8", "mul"),
    111: ("<i1", "add_sat"), 112: ("<u1", "add_sat"),
    114: ("<i1", "sub_sat"), 115: ("<u1", "sub_sat"),
    143: ("<i2", "add_sat"), 144: ("<u2", "add_sat"),
    146: ("<i2", "sub_sat"), 147: ("<u2", "sub_sat"),
    118: ("<i1", "min"), 119: ("<u1", "min"),
    120: ("<i1", "max"), 121: ("<u1", "max"),
    150: ("<i2", "min"), 151: ("<u2", "min"),
    152: ("<i2", "max"), 153: ("<u2", "max"),
    182: ("<i4", "min"), 183: ("<u4", "min"),
    184: ("<i4", "max"), 185: ("<u4", "max"),
    123: ("<u1", "avgr"), 155: ("<u2", "avgr"),
}
_SIMD_IUN = {
    96: ("<i1", "abs"), 97: ("<u1", "neg"), 98: ("<u1", "popcnt"),
    128: ("<i2", "abs"), 129: ("<u2", "neg"),
    160: ("<i4", "abs"), 161: ("<u4", "neg"),
    192: ("<i8", "abs"), 193: ("<u8", "neg"),
}
_SIMD_ALLTRUE = {99: "<u1", 131: "<u2", 163: "<u4", 195: "<u8"}
_SIMD_BITMASK = {100: "<i1", 132: "<i2", 164: "<i4", 196: "<i8"}
_SIMD_SHIFT = {
    107: ("<u1", "shl"), 108: ("<i1", "shr"), 109: ("<u1", "shr"),
    139: ("<u2", "shl"), 140: ("<i2", "shr"), 141: ("<u2", "shr"),
    171: ("<u4", "shl"), 172: ("<i4", "shr"), 173: ("<u4", "shr"),
    203: ("<u8", "shl"), 204: ("<i8", "shr"), 205: ("<u8", "shr"),
}
_SIMD_FUN = {
    103: ("<f4", "ceil"), 104: ("<f4", "floor"), 105: ("<f4", "trunc"),
    106: ("<f4", "nearest"), 116: ("<f8", "ceil"), 117: ("<f8", "floor"),
    122: ("<f8", "trunc"), 148: ("<f8", "nearest"),
    224: ("<f4", "abs"), 225: ("<f4", "neg"), 227: ("<f4", "sqrt"),
    236: ("<f8", "abs"), 237: ("<f8", "neg"), 239: ("<f8", "sqrt"),
}
_SIMD_FBIN = {}
for _b, _dt in ((228, "<f4"), (240, "<f8")):
    for _j, _nm in enumerate(("add", "sub", "mul", "div",
                              "min", "max", "pmin", "pmax")):
        _SIMD_FBIN[_b + _j] = (_dt, _nm)

_SIMD_NARROW = {101: ("<i2", "<i1"), 102: ("<i2", "<u1"),
                133: ("<i4", "<i2"), 134: ("<i4", "<u2")}
_SIMD_EXTEND = {}
for _b, _src, _dst in ((135, "<i1", "<i2"), (167, "<i2", "<i4"),
                       (199, "<i4", "<i8")):
    _usrc = "<u" + _src[2]
    _udst = "<u" + _dst[2]
    _SIMD_EXTEND[_b] = (_src, _dst, "low")
    _SIMD_EXTEND[_b + 1] = (_src, _dst, "high")
    _SIMD_EXTEND[_b + 2] = (_usrc, _udst, "low")
    _SIMD_EXTEND[_b + 3] = (_usrc, _udst, "high")

# lane counts for extract/replace immediates (decode-time validation)
_SIMD_LANE_N = {21: 16, 22: 16, 23: 16, 24: 8, 25: 8, 26: 8,
                27: 4, 28: 4, 29: 2, 30: 2, 31: 4, 32: 4, 33: 2, 34: 2}

_SIMD_SUPPORTED = (
    set(range(14, 21)) | set(_SIMD_CMP) | set(range(77, 84))
    | set(_SIMD_IBIN) | set(_SIMD_IUN) | set(_SIMD_ALLTRUE)
    | set(_SIMD_BITMASK) | set(_SIMD_SHIFT) | set(_SIMD_FUN)
    | set(_SIMD_FBIN) | set(_SIMD_NARROW) | set(_SIMD_EXTEND)
    | {94, 95, 186} | set(range(248, 256))
)


# opcode name tables keep the decoder readable; executor dispatches on int.

def _decode_expr(r: _Reader, types=None) -> list:
    """Decode instructions until the matching 0x0B end (depth balanced)."""
    out = []
    depth = 0
    while True:
        op = r.u8()
        if op in (0x02, 0x03, 0x04):            # block, loop, if
            out.append((op, _decode_blocktype(r, types)))
            depth += 1
        elif op == 0x05:                        # else
            out.append((op,))
        elif op == 0x0B:                        # end
            out.append((op,))
            if depth == 0:
                return out
            depth -= 1
        elif op in (0x0C, 0x0D):                # br, br_if
            out.append((op, r.uleb()))
        elif op == 0x0E:                        # br_table
            n = r.uleb()
            targets = [r.uleb() for _ in range(n)]
            out.append((op, targets, r.uleb()))
        elif op == 0x0F:                        # return
            out.append((op,))
        elif op == 0x10:                        # call
            out.append((op, r.uleb()))
        elif op == 0x11:                        # call_indirect
            out.append((op, r.uleb(), r.uleb()))
        elif op in (0x00, 0x01):                # unreachable, nop
            out.append((op,))
        elif op in (0x1A, 0x1B):                # drop, select
            out.append((op,))
        elif op in (0x20, 0x21, 0x22, 0x23, 0x24):  # local/global access
            out.append((op, r.uleb()))
        elif op in (0x25, 0x26):                # table.get/set (table 0)
            if r.uleb() != 0:
                raise WasmError("only table 0 supported")
            out.append((op,))
        elif op == 0xD0:                        # ref.null t -> -1
            r.u8()
            out.append((op,))
        elif op == 0xD1:                        # ref.is_null
            out.append((op,))
        elif op == 0xD2:                        # ref.func f
            out.append((op, r.uleb()))
        elif 0x28 <= op <= 0x3E:                # loads & stores
            align, offset = r.uleb(), r.uleb()
            out.append((op, align, offset))
        elif op in (0x3F, 0x40):                # memory.size, memory.grow
            r.uleb()                            # reserved 0x00
            out.append((op,))
        elif op == 0x41:
            # canonical value representation is unsigned (ALU ops wrap)
            out.append((op, r.sleb(32) & 0xFFFFFFFF))
        elif op == 0x42:
            out.append((op, r.sleb(64) & 0xFFFFFFFFFFFFFFFF))
        elif op == 0x43:
            out.append((op, r.f32()))
        elif op == 0x44:
            out.append((op, r.f64()))
        elif 0x45 <= op <= 0xC4:                # numeric ops, no immediates
            out.append((op,))
        elif op == 0xFC:                        # misc prefix (bulk memory
            sub = r.uleb()                      # + saturating truncation)
            if sub <= 7:                        # ixx.trunc_sat_fyy_s/u
                out.append((0xFC00 | sub,))
            elif sub == 8:                      # memory.init dataidx mem
                seg = r.uleb()
                if r.u8() != 0:
                    raise WasmError("memory.init: only memory 0")
                out.append((0xFC08, seg))
            elif sub == 9:                      # data.drop dataidx
                out.append((0xFC09, r.uleb()))
            elif sub == 10:                     # memory.copy mem mem
                if r.u8() != 0 or r.u8() != 0:
                    raise WasmError("memory.copy: only memory 0")
                out.append((0xFC0A,))
            elif sub == 11:                     # memory.fill mem
                if r.u8() != 0:
                    raise WasmError("memory.fill: only memory 0")
                out.append((0xFC0B,))
            elif sub == 12:                     # table.init elem table
                seg = r.uleb()
                if r.uleb() != 0:
                    raise WasmError("table.init: only table 0")
                out.append((0xFC0C, seg))
            elif sub == 13:                     # elem.drop elemidx
                out.append((0xFC0D, r.uleb()))
            elif sub == 14:                     # table.copy table table
                if r.uleb() != 0 or r.uleb() != 0:
                    raise WasmError("table.copy: only table 0")
                out.append((0xFC0E,))
            elif sub in (15, 16, 17):           # table.grow/size/fill
                if r.uleb() != 0:
                    raise WasmError("table.*: only table 0")
                out.append((0xFC00 | sub,))
            else:
                raise WasmError(f"unsupported 0xFC opcode {sub}")
        elif op == 0xFD:                        # SIMD prefix
            sub = r.uleb()
            # ops are re-keyed as 0xFD00|sub so the executor still
            # dispatches on one int
            if sub <= 11 or sub in (92, 93):    # loads/store: memarg
                align, offset = r.uleb(), r.uleb()
                out.append((0xFD00 | sub, align, offset))
            elif 84 <= sub <= 91:               # lane load/store: +lane
                align, offset = r.uleb(), r.uleb()
                lane = r.u8()
                if lane >= 16 >> ((sub - 84) & 3):
                    raise WasmError(f"lane {lane} out of range for "
                                    f"SIMD op 0xfd {sub}")
                out.append((0xFD00 | sub, align, offset, lane))
            elif sub in (12, 13):               # const / shuffle: 16 bytes
                imm = bytes(r.b[r.p:r.p + 16])
                if len(imm) != 16:
                    raise WasmError("truncated v128 immediate")
                r.p += 16
                if sub == 13 and any(i >= 32 for i in imm):
                    raise WasmError("shuffle lane index >= 32")
                out.append((0xFD00 | sub, imm))
            elif 21 <= sub <= 34:               # lane ops: lane index
                lane = r.u8()
                if lane >= _SIMD_LANE_N[sub]:
                    raise WasmError(f"lane {lane} out of range for "
                                    f"SIMD op 0xfd {sub}")
                out.append((0xFD00 | sub, lane))
            elif sub in _SIMD_SUPPORTED:
                out.append((0xFD00 | sub,))
            else:
                raise WasmError(f"unsupported SIMD opcode 0xfd {sub} "
                                "(q15mulr/extadd/extmul/relaxed tail is "
                                "out of scope; see module docstring)")
        else:
            raise WasmError(f"unsupported opcode 0x{op:02x}")


def decode_module(data: bytes) -> Module:
    if not data.startswith(MAGIC):
        raise WasmError("bad magic (not a wasm binary, or not version 1)")
    r = _Reader(data, len(MAGIC))
    m = Module()
    func_type_idx: list[int] = []
    bodies: list[tuple] = []

    while not r.eof():
        sec = r.u8()
        size = r.uleb()
        body = _Reader(r.bytes_(size))
        if sec == 1:                                     # type
            for _ in range(body.uleb()):
                if body.u8() != 0x60:
                    raise WasmError("bad functype tag")
                params = tuple(_decode_valtype(body)
                               for _ in range(body.uleb()))
                results = tuple(_decode_valtype(body)
                                for _ in range(body.uleb()))
                m.types.append(FuncType(params, results))
        elif sec == 2:                                   # import
            for _ in range(body.uleb()):
                mod, name = body.name(), body.name()
                kind = body.u8()
                if kind == 0x00:                         # func
                    ti = body.uleb()
                    m.imports.append((mod, name, "func", ti))
                    m.n_imported_funcs += 1
                elif kind == 0x02:                       # memory import
                    flags = body.u8()
                    mn = body.uleb()
                    mx = body.uleb() if flags & 1 else None
                    m.imports.append((mod, name, "memory", (mn, mx)))
                    m.mem_min = max(m.mem_min, mn)
                else:
                    raise WasmError(
                        f"unsupported import kind {kind} for {mod}.{name}")
        elif sec == 3:                                   # function
            func_type_idx = [body.uleb() for _ in range(body.uleb())]
        elif sec == 4:                                   # table
            for _ in range(body.uleb()):
                if body.u8() != 0x70:
                    raise WasmError("only funcref tables supported")
                flags = body.u8()
                m.table_min = body.uleb()
                if flags & 1:
                    m.table_max = body.uleb()
        elif sec == 5:                                   # memory
            for _ in range(body.uleb()):
                flags = body.u8()
                m.mem_min = body.uleb()
                if flags & 1:
                    m.mem_max = body.uleb()
        elif sec == 6:                                   # global
            for _ in range(body.uleb()):
                vt = _decode_valtype(body)
                mut = body.u8()
                init = _decode_expr(body)
                m.globals.append((vt, bool(mut), init))
        elif sec == 7:                                   # export
            for _ in range(body.uleb()):
                name = body.name()
                kind, idx = body.u8(), body.uleb()
                m.exports[name] = (("func", "table", "memory",
                                    "global")[kind], idx)
        elif sec == 8:                                   # start
            m.start = body.uleb()
        elif sec == 9:                                   # elem
            # full flag matrix (spec 5.5.12): bit0 passive/declared,
            # bit1 explicit-table-or-declared, bit2 expr-encoded refs
            def _ref_expr(r: _Reader) -> int:
                op = r.u8()
                if op == 0xD2:                  # ref.func f
                    v = r.uleb()
                elif op == 0xD0:                # ref.null t
                    r.u8()
                    v = -1
                else:
                    raise WasmError(f"unsupported elem expr op {op:#x}")
                if r.u8() != 0x0B:
                    raise WasmError("elem expr: expected end")
                return v

            for _ in range(body.uleb()):
                flags = body.uleb()
                if flags > 7:
                    raise WasmError(f"bad elem segment flags {flags}")
                off = None
                if flags & 1 == 0:                       # active
                    if flags & 2:                        # explicit table
                        if body.uleb() != 0:
                            raise WasmError("only table 0 supported")
                    off = _const_expr_value(_decode_expr(body))
                if flags & 3 != 0:
                    # elemkind (0x00 = funcref) or reftype (0x70)
                    if body.u8() not in (0x00, 0x70):
                        raise WasmError("only funcref elem segments")
                refs = [(_ref_expr(body) if flags & 4 else body.uleb())
                        for _ in range(body.uleb())]
                mode = ("active" if flags & 1 == 0
                        else "declared" if flags & 3 == 3 else "passive")
                m.elemsegs.append((mode, off, refs))
        elif sec == 10:                                  # code
            for _ in range(body.uleb()):
                sz = body.uleb()
                fr = _Reader(body.bytes_(sz))
                locals_: list[int] = []
                for _ in range(fr.uleb()):
                    count, vt = fr.uleb(), _decode_valtype(fr)
                    locals_.extend([vt] * count)
                bodies.append((locals_, _decode_expr(fr, m.types)))
        elif sec == 11:                                  # data
            for _ in range(body.uleb()):
                flags = body.uleb()
                if flags == 1:                           # passive
                    payload = body.bytes_(body.uleb())
                    m.datasegs.append(("passive", payload))
                    continue
                if flags == 2 and body.uleb() != 0:      # explicit memidx
                    raise WasmError("only memory-0 data segments")
                elif flags not in (0, 2):
                    raise WasmError(f"bad data segment flags {flags}")
                off_expr = _decode_expr(body)
                payload = body.bytes_(body.uleb())
                m.data.append((_const_expr_value(off_expr), payload))
                m.datasegs.append(("active", payload))
        # custom (0), datacount (12) and unknown sections are skipped
        # (the decoder doesn't need the datacount hint: code is decoded
        # after the full module is read)

    if len(func_type_idx) != len(bodies):
        raise WasmError("function/code section mismatch")
    for ti, (locals_, code) in zip(func_type_idx, bodies):
        m.funcs.append(Function(m.types[ti], locals_, code))
    for name, (kind, idx) in m.exports.items():
        if kind == "func" and idx >= m.n_imported_funcs:
            m.funcs[idx - m.n_imported_funcs].name = name
    return m


def _const_expr_value(expr: list) -> int:
    if len(expr) >= 1 and expr[0][0] in (0x41, 0x42):
        return expr[0][1]
    raise WasmError("unsupported constant expression")


# ---------------------------------------------------------------- execution

def _wrap32(v: int) -> int:
    return v & 0xFFFFFFFF


def _wrap64(v: int) -> int:
    return v & 0xFFFFFFFFFFFFFFFF


def _sign32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v & 0x80000000 else v


def _sign64(v: int) -> int:
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v & (1 << 63) else v


def _trunc_sat(sub: int, v: float) -> int:
    """0xFC 0..7: saturating float->int truncation (NaN -> 0, out of
    range clamps — never traps).  Result in canonical unsigned form."""
    signed = (sub & 1) == 0      # 0,2,4,6 = _s; 1,3,5,7 = _u
    bits = 64 if sub >= 4 else 32
    if math.isnan(v):
        return 0
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    if v <= lo:
        t = lo
    elif v >= hi:
        t = hi
    else:
        t = math.trunc(v)
    return _wrap32(t) if bits == 32 else _wrap64(t)


def _trunc(v: float, lo: int, hi: int, name: str) -> int:
    if math.isnan(v) or math.isinf(v):
        raise Trap(f"invalid conversion to integer ({name})")
    t = math.trunc(v)
    if t < lo or t > hi:
        raise Trap(f"integer overflow in {name}")
    return t


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


class _Label:
    __slots__ = ("arity", "stack_h", "cont", "is_loop")

    def __init__(self, arity, stack_h, cont, is_loop):
        self.arity = arity
        self.stack_h = stack_h
        self.cont = cont          # instruction index to jump to on br
        self.is_loop = is_loop


class Instance:
    """An instantiated module: memory, globals, and callable exports."""

    MAX_STEPS = 200_000_000

    def __init__(self, module: Module,
                 host: dict[tuple[str, str], Callable]):
        self.m = module
        self.mem = bytearray(module.mem_min * PAGE)
        self.mem_max = module.mem_max
        self.globals: list[Any] = []
        for vt, _mut, init in module.globals:
            self.globals.append(_const_expr_value(init)
                                if init[0][0] in (0x41, 0x42)
                                else (init[0][1] if init[0][0] in
                                      (0x43, 0x44, 0xFD0C) else 0))
        self.host: list[Optional[Callable]] = []
        self.host_types: list[FuncType] = []
        for mod, name, kind, extra in module.imports:
            if kind == "func":
                fn = host.get((mod, name))
                if fn is None:
                    raise WasmError(f"unresolved import {mod}.{name}")
                self.host.append(fn)
                self.host_types.append(module.types[extra])
        for off, payload in module.data:
            end = off + len(payload)
            if end > len(self.mem):
                raise WasmError("data segment out of bounds")
            self.mem[off:end] = payload
        # runtime segment store for memory.init/data.drop: passive
        # segments keep their bytes until dropped; active segments are
        # implicitly dropped at instantiation (bulk-memory spec)
        self.datasegs: list[Optional[bytes]] = [
            payload if mode == "passive" else None
            for mode, payload in module.datasegs]
        # runtime funcref table (-1 = null) + elem segment store with
        # the same lifecycle as datasegs: active applied then dropped,
        # declared born dropped, passive live until elem.drop
        self.table: list[int] = [-1] * module.table_min
        self.elemsegs: list[Optional[list[int]]] = []
        for mode, off, refs in module.elemsegs:
            if mode == "active":
                if off + len(refs) > len(self.table):
                    raise WasmError("elem segment out of bounds")
                self.table[off: off + len(refs)] = refs
                self.elemsegs.append(None)
            else:
                self.elemsegs.append(list(refs)
                                     if mode == "passive" else None)
        self.steps = 0
        if module.start is not None:
            self._call_function(module.start, [])

    # -- public API ------------------------------------------------------
    @property
    def exports(self) -> list[str]:
        return [n for n, (k, _) in self.m.exports.items() if k == "func"]

    def invoke(self, name: str, args: list) -> list:
        if name not in self.m.exports or self.m.exports[name][0] != "func":
            raise WasmError(f"no exported function '{name}'")
        self.steps = 0
        return self._call_function(self.m.exports[name][1], list(args))

    # memory helpers for host functions
    def mem_read(self, ptr: int, n: int) -> bytes:
        if ptr < 0 or ptr + n > len(self.mem):
            raise Trap("host memory read out of bounds")
        return bytes(self.mem[ptr:ptr + n])

    def mem_write(self, ptr: int, data: bytes) -> None:
        if ptr < 0 or ptr + len(data) > len(self.mem):
            raise Trap("host memory write out of bounds")
        self.mem[ptr:ptr + len(data)] = data

    def mem_read_cstr(self, ptr: int, maxlen: int = 1 << 20) -> bytes:
        end = self.mem.find(b"\0", ptr, min(ptr + maxlen, len(self.mem)))
        if end < 0:
            raise Trap("unterminated string in wasm memory")
        return bytes(self.mem[ptr:end])

    # -- function invocation ---------------------------------------------
    def _call_function(self, idx: int, args: list) -> list:
        n_imp = self.m.n_imported_funcs
        if idx < n_imp:
            ft = self.host_types[idx]
            res = self.host[idx](self, *args)
            if res is None:
                return []
            if isinstance(res, tuple):
                return list(res)
            return [res] if ft.results else []
        fn = self.m.funcs[idx - n_imp]
        locals_: list[Any] = [
            _wrap32(a) if t == I32 else (_wrap64(a) if t == I64 else a)
            for a, t in zip(args, fn.type.params)]
        for vt in fn.locals:
            locals_.append(b"\x00" * 16 if vt == V128
                           else 0.0 if vt in (F32, F64) else 0)
        return self._exec(fn, locals_)

    # -- the interpreter loop --------------------------------------------
    def _exec(self, fn: Function, locals_: list) -> list:
        code = fn.body
        stack: list[Any] = []
        labels: list[_Label] = [
            _Label(len(fn.type.results), 0, len(code) - 1, False)]
        pc = 0
        mem = self.mem

        def grow_check() -> None:
            self.steps += 1
            if self.steps > self.MAX_STEPS:
                raise Trap("execution budget exceeded (runaway loop?)")

        def find_matching(from_pc: int) -> tuple[int, int]:
            """For block/loop/if at from_pc: (else_pc|-1, end_pc)."""
            depth = 0
            else_pc = -1
            i = from_pc + 1
            while i < len(code):
                op2 = code[i][0]
                if op2 in (0x02, 0x03, 0x04):
                    depth += 1
                elif op2 == 0x05 and depth == 0:
                    else_pc = i
                elif op2 == 0x0B:
                    if depth == 0:
                        return else_pc, i
                    depth -= 1
                i += 1
            raise WasmError("unbalanced block")

        def do_branch(n: int) -> int:
            # br n targets the n-th enclosing label: a loop branch re-enters
            # (its label survives), a block branch exits (label popped too)
            lbl = labels[-1 - n]
            keep = stack[len(stack) - lbl.arity:] if lbl.arity else []
            del stack[lbl.stack_h:]
            stack.extend(keep)
            if lbl.is_loop:
                del labels[len(labels) - n:]
            else:
                del labels[len(labels) - n - 1:]
            return lbl.cont

        while pc < len(code):
            ins = code[pc]
            op = ins[0]
            grow_check()

            if op == 0x0B:                       # end
                if len(labels) > 1:
                    labels.pop()
                pc += 1
                continue
            if op == 0x01:                       # nop
                pc += 1
                continue
            if op == 0x00:
                raise Trap("unreachable executed")
            if op == 0x02:                       # block
                _else, end = find_matching(pc)
                bt_params, bt_results = ins[1]
                labels.append(_Label(len(bt_results),
                                     len(stack) - len(bt_params),
                                     end + 1, False))
                pc += 1
                continue
            if op == 0x03:                       # loop
                # cont = first instruction INSIDE: a br re-enters the body
                # without re-executing the loop opcode (label is kept live
                # by do_branch, so it is pushed exactly once).  A branch
                # to a loop carries the loop's PARAMS back to the top.
                bt_params, _bt_results = ins[1]
                labels.append(_Label(len(bt_params),
                                     len(stack) - len(bt_params),
                                     pc + 1, True))
                pc += 1
                continue
            if op == 0x04:                       # if
                else_pc, end = find_matching(pc)
                cond = stack.pop()
                bt_params, bt_results = ins[1]
                labels.append(_Label(len(bt_results),
                                     len(stack) - len(bt_params),
                                     end + 1, False))
                if cond:
                    pc += 1
                else:
                    pc = (else_pc + 1) if else_pc >= 0 else end
                continue
            if op == 0x05:                       # else (end of then-arm)
                pc = labels[-1].cont             # jump past end
                labels.pop()
                continue
            if op == 0x0C:                       # br
                pc = do_branch(ins[1])
                continue
            if op == 0x0D:                       # br_if
                if stack.pop():
                    pc = do_branch(ins[1])
                else:
                    pc += 1
                continue
            if op == 0x0E:                       # br_table
                i = stack.pop()
                targets, default = ins[1], ins[2]
                n = targets[i] if 0 <= i < len(targets) else default
                pc = do_branch(n)
                continue
            if op == 0x0F:                       # return
                arity = len(fn.type.results)
                return stack[len(stack) - arity:] if arity else []
            if op == 0x10:                       # call
                callee_idx = ins[1]
                ft = (self.host_types[callee_idx]
                      if callee_idx < self.m.n_imported_funcs
                      else self.m.funcs[
                          callee_idx - self.m.n_imported_funcs].type)
                argn = len(ft.params)
                args = stack[len(stack) - argn:] if argn else []
                del stack[len(stack) - argn:]
                stack.extend(self._call_function(callee_idx, args))
                pc += 1
                continue
            if op == 0x11:                       # call_indirect
                ti = ins[1]
                elem_i = stack.pop()
                target = self.table[elem_i] \
                    if 0 <= elem_i < len(self.table) else -1
                if target < 0:
                    raise Trap("undefined table element")
                ft = self.m.types[ti]
                argn = len(ft.params)
                args = stack[len(stack) - argn:] if argn else []
                del stack[len(stack) - argn:]
                stack.extend(self._call_function(target, args))
                pc += 1
                continue
            if op == 0xD0:                       # ref.null -> -1
                stack.append(-1)
            elif op == 0xD1:                     # ref.is_null
                stack.append(1 if stack.pop() < 0 else 0)
            elif op == 0xD2:                     # ref.func f
                stack.append(ins[1])
            elif op == 0x25:                     # table.get
                i = _wrap32(stack.pop())
                if i >= len(self.table):
                    raise Trap("out of bounds table.get")
                stack.append(self.table[i])
            elif op == 0x26:                     # table.set
                v = stack.pop()
                i = _wrap32(stack.pop())
                if i >= len(self.table):
                    raise Trap("out of bounds table.set")
                self.table[i] = v
            elif op == 0x1A:                     # drop
                stack.pop()
            elif op == 0x1B:                     # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == 0x20:
                stack.append(locals_[ins[1]])
            elif op == 0x21:
                locals_[ins[1]] = stack.pop()
            elif op == 0x22:
                locals_[ins[1]] = stack[-1]
            elif op == 0x23:
                stack.append(self.globals[ins[1]])
            elif op == 0x24:
                self.globals[ins[1]] = stack.pop()
            elif 0x28 <= op <= 0x35:             # loads
                addr = _wrap32(stack.pop()) + ins[2]
                stack.append(self._load(op, addr))
            elif 0x36 <= op <= 0x3E:             # stores
                val = stack.pop()
                addr = _wrap32(stack.pop()) + ins[2]
                self._store(op, addr, val)
            elif op == 0x3F:                     # memory.size
                stack.append(len(mem) // PAGE)
            elif op == 0x40:                     # memory.grow
                delta = _wrap32(stack.pop())
                old = len(self.mem) // PAGE
                new = old + delta
                # wasm32 hard ceiling (65536 pages = 4 GiB) applies even
                # with no declared max; failure pushes -1, never raises
                cap = self.mem_max if self.mem_max is not None else 65536
                if new > min(cap, 65536):
                    stack.append(_wrap32(-1))
                else:
                    try:
                        self.mem.extend(b"\0" * (delta * PAGE))
                    except MemoryError:
                        stack.append(_wrap32(-1))
                    else:
                        mem = self.mem
                        stack.append(old)
            elif op in (0x41, 0x42, 0x43, 0x44):  # consts
                stack.append(ins[1])
            elif 0xFC00 <= op <= 0xFC07:         # ixx.trunc_sat_fyy_s/u
                stack.append(_trunc_sat(op & 7, stack.pop()))
            elif op == 0xFC08:                   # memory.init
                n = _wrap32(stack.pop())
                s = _wrap32(stack.pop())
                d = _wrap32(stack.pop())
                seg = self.datasegs[ins[1]]
                src = seg if seg is not None else b""   # dropped = empty
                if s + n > len(src) or d + n > len(mem):
                    raise Trap("out of bounds memory.init")
                mem[d:d + n] = src[s:s + n]
            elif op == 0xFC09:                   # data.drop
                self.datasegs[ins[1]] = None
            elif op == 0xFC0A:                   # memory.copy (memmove)
                n = _wrap32(stack.pop())
                s = _wrap32(stack.pop())
                d = _wrap32(stack.pop())
                if s + n > len(mem) or d + n > len(mem):
                    raise Trap("out of bounds memory.copy")
                mem[d:d + n] = bytes(mem[s:s + n])
            elif op == 0xFC0B:                   # memory.fill
                n = _wrap32(stack.pop())
                v = _wrap32(stack.pop()) & 0xFF
                d = _wrap32(stack.pop())
                if d + n > len(mem):
                    raise Trap("out of bounds memory.fill")
                mem[d:d + n] = bytes([v]) * n
            elif op == 0xFC0C:                   # table.init
                n = _wrap32(stack.pop())
                s = _wrap32(stack.pop())
                d = _wrap32(stack.pop())
                seg = self.elemsegs[ins[1]] \
                    if ins[1] < len(self.elemsegs) else None
                src = seg if seg is not None else []
                if s + n > len(src) or d + n > len(self.table):
                    raise Trap("out of bounds table.init")
                self.table[d:d + n] = src[s:s + n]
            elif op == 0xFC0D:                   # elem.drop
                if ins[1] < len(self.elemsegs):
                    self.elemsegs[ins[1]] = None
            elif op == 0xFC0E:                   # table.copy (memmove)
                n = _wrap32(stack.pop())
                s = _wrap32(stack.pop())
                d = _wrap32(stack.pop())
                if s + n > len(self.table) or d + n > len(self.table):
                    raise Trap("out of bounds table.copy")
                self.table[d:d + n] = self.table[s:s + n]
            elif op == 0xFC0F:                   # table.grow
                n = _wrap32(stack.pop())
                v = stack.pop()
                old = len(self.table)
                # like memory.grow's 4 GiB page ceiling: an untrusted
                # module must not be able to allocate unbounded host
                # memory through a no-max table — failure is the
                # spec's -1, never a host MemoryError
                cap = self.m.table_max if self.m.table_max is not None \
                    else 1 << 20
                if old + n > cap:
                    stack.append(_wrap32(-1))
                else:
                    try:
                        self.table.extend([v] * n)
                        stack.append(old)
                    except MemoryError:
                        stack.append(_wrap32(-1))
            elif op == 0xFC10:                   # table.size
                stack.append(len(self.table))
            elif op == 0xFC11:                   # table.fill
                n = _wrap32(stack.pop())
                v = stack.pop()
                i = _wrap32(stack.pop())
                if i + n > len(self.table):
                    raise Trap("out of bounds table.fill")
                self.table[i:i + n] = [v] * n
            elif op >= 0xFD00:                   # SIMD (pops/pushes itself)
                self._simd(ins, stack)
            else:
                stack.append(self._numeric(op, stack))
                # _numeric pops its own operands and returns the result
            pc += 1

        arity = len(fn.type.results)
        return stack[len(stack) - arity:] if arity else []

    # -- memory ----------------------------------------------------------
    _LOADS = {
        0x28: ("<i", 4, False), 0x29: ("<q", 8, False),
        0x2A: ("<f", 4, False), 0x2B: ("<d", 8, False),
        0x2C: ("<b", 1, False), 0x2D: ("<B", 1, False),
        0x2E: ("<h", 2, False), 0x2F: ("<H", 2, False),
        0x30: ("<b", 1, True), 0x31: ("<B", 1, True),
        0x32: ("<h", 2, True), 0x33: ("<H", 2, True),
        0x34: ("<i", 4, True), 0x35: ("<I", 4, True),
    }

    def _load(self, op: int, addr: int):
        fmtc, n, to64 = self._LOADS[op]
        if addr + n > len(self.mem):
            raise Trap("out-of-bounds memory access")
        v = struct.unpack_from(fmtc, self.mem, addr)[0]
        if op in (0x28,):
            return _wrap32(v)
        if op in (0x29,):
            return _wrap64(v)
        if to64:
            return _wrap64(v) if fmtc in ("<i", "<b", "<h") else v
        if fmtc in ("<b", "<h"):
            return _wrap32(v)
        return v

    _STORES = {
        0x36: ("<I", 4), 0x37: ("<Q", 8), 0x38: ("<f", 4), 0x39: ("<d", 8),
        0x3A: ("<B", 1), 0x3B: ("<H", 2), 0x3C: ("<B", 1), 0x3D: ("<H", 2),
        0x3E: ("<I", 4),
    }

    def _store(self, op: int, addr: int, val) -> None:
        fmtc, n = self._STORES[op]
        if addr + n > len(self.mem):
            raise Trap("out-of-bounds memory access")
        if fmtc == "<B":
            val = int(val) & 0xFF
        elif fmtc == "<H":
            val = int(val) & 0xFFFF
        elif fmtc == "<I":
            val = int(val) & 0xFFFFFFFF
        elif fmtc == "<Q":
            val = int(val) & 0xFFFFFFFFFFFFFFFF
        struct.pack_into(fmtc, self.mem, addr, val)

    # -- numeric ops ------------------------------------------------------
    def _numeric(self, op: int, stack: list):
        # i32 compares / ALU --------------------------------------------
        if op == 0x45:                            # i32.eqz
            return int(stack.pop() == 0)
        if 0x46 <= op <= 0x4F:
            b, a = stack.pop(), stack.pop()
            sa, sb = _sign32(a), _sign32(b)
            ua, ub = _wrap32(a), _wrap32(b)
            return int({
                0x46: ua == ub, 0x47: ua != ub,
                0x48: sa < sb, 0x49: ua < ub,
                0x4A: sa > sb, 0x4B: ua > ub,
                0x4C: sa <= sb, 0x4D: ua <= ub,
                0x4E: sa >= sb, 0x4F: ua >= ub,
            }[op])
        if op == 0x50:                            # i64.eqz
            return int(stack.pop() == 0)
        if 0x51 <= op <= 0x5A:
            b, a = stack.pop(), stack.pop()
            sa, sb = _sign64(a), _sign64(b)
            ua, ub = _wrap64(a), _wrap64(b)
            return int({
                0x51: ua == ub, 0x52: ua != ub,
                0x53: sa < sb, 0x54: ua < ub,
                0x55: sa > sb, 0x56: ua > ub,
                0x57: sa <= sb, 0x58: ua <= ub,
                0x59: sa >= sb, 0x5A: ua >= ub,
            }[op])
        if 0x5B <= op <= 0x60:                    # f32 compares
            b, a = stack.pop(), stack.pop()
            return int({0x5B: a == b, 0x5C: a != b, 0x5D: a < b,
                        0x5E: a > b, 0x5F: a <= b, 0x60: a >= b}[op])
        if 0x61 <= op <= 0x66:                    # f64 compares
            b, a = stack.pop(), stack.pop()
            return int({0x61: a == b, 0x62: a != b, 0x63: a < b,
                        0x64: a > b, 0x65: a <= b, 0x66: a >= b}[op])

        if op == 0x67:                            # i32.clz
            v = _wrap32(stack.pop())
            return 32 if v == 0 else 32 - v.bit_length()
        if op == 0x68:                            # i32.ctz
            v = _wrap32(stack.pop())
            return 32 if v == 0 else (v & -v).bit_length() - 1
        if op == 0x69:                            # i32.popcnt
            return bin(_wrap32(stack.pop())).count("1")
        if 0x6A <= op <= 0x78:                    # i32 binary ALU
            b, a = stack.pop(), stack.pop()
            ua, ub = _wrap32(a), _wrap32(b)
            sa, sb = _sign32(a), _sign32(b)
            if op == 0x6A:
                return _wrap32(ua + ub)
            if op == 0x6B:
                return _wrap32(ua - ub)
            if op == 0x6C:
                return _wrap32(ua * ub)
            if op == 0x6D:                        # div_s
                if ub == 0:
                    raise Trap("integer divide by zero")
                q = abs(sa) // abs(sb)
                q = -q if (sa < 0) != (sb < 0) else q
                if q == 0x80000000:
                    raise Trap("integer overflow")
                return _wrap32(q)
            if op == 0x6E:
                if ub == 0:
                    raise Trap("integer divide by zero")
                return ua // ub
            if op == 0x6F:                        # rem_s
                if ub == 0:
                    raise Trap("integer divide by zero")
                r = abs(sa) % abs(sb)
                return _wrap32(-r if sa < 0 else r)
            if op == 0x70:
                if ub == 0:
                    raise Trap("integer divide by zero")
                return ua % ub
            if op == 0x71:
                return ua & ub
            if op == 0x72:
                return ua | ub
            if op == 0x73:
                return ua ^ ub
            if op == 0x74:
                return _wrap32(ua << (ub % 32))
            if op == 0x75:
                return _wrap32(sa >> (ub % 32))
            if op == 0x76:
                return ua >> (ub % 32)
            if op == 0x77:                        # rotl
                k = ub % 32
                return _wrap32((ua << k) | (ua >> (32 - k))) if k else ua
            if op == 0x78:                        # rotr
                k = ub % 32
                return _wrap32((ua >> k) | (ua << (32 - k))) if k else ua

        if op == 0x79:                            # i64.clz
            v = _wrap64(stack.pop())
            return 64 if v == 0 else 64 - v.bit_length()
        if op == 0x7A:
            v = _wrap64(stack.pop())
            return 64 if v == 0 else (v & -v).bit_length() - 1
        if op == 0x7B:
            return bin(_wrap64(stack.pop())).count("1")
        if 0x7C <= op <= 0x8A:                    # i64 binary ALU
            b, a = stack.pop(), stack.pop()
            ua, ub = _wrap64(a), _wrap64(b)
            sa, sb = _sign64(a), _sign64(b)
            if op == 0x7C:
                return _wrap64(ua + ub)
            if op == 0x7D:
                return _wrap64(ua - ub)
            if op == 0x7E:
                return _wrap64(ua * ub)
            if op == 0x7F:
                if ub == 0:
                    raise Trap("integer divide by zero")
                q = abs(sa) // abs(sb)
                q = -q if (sa < 0) != (sb < 0) else q
                if q == 1 << 63:
                    raise Trap("integer overflow")
                return _wrap64(q)
            if op == 0x80:
                if ub == 0:
                    raise Trap("integer divide by zero")
                return ua // ub
            if op == 0x81:
                if ub == 0:
                    raise Trap("integer divide by zero")
                r = abs(sa) % abs(sb)
                return _wrap64(-r if sa < 0 else r)
            if op == 0x82:
                if ub == 0:
                    raise Trap("integer divide by zero")
                return ua % ub
            if op == 0x83:
                return ua & ub
            if op == 0x84:
                return ua | ub
            if op == 0x85:
                return ua ^ ub
            if op == 0x86:
                return _wrap64(ua << (ub % 64))
            if op == 0x87:
                return _wrap64(sa >> (ub % 64))
            if op == 0x88:
                return ua >> (ub % 64)
            if op == 0x89:
                k = ub % 64
                return _wrap64((ua << k) | (ua >> (64 - k))) if k else ua
            if op == 0x8A:
                k = ub % 64
                return _wrap64((ua >> k) | (ua << (64 - k))) if k else ua

        # f32/f64 unary & binary ----------------------------------------
        if 0x8B <= op <= 0x91:                    # f32 unary
            a = stack.pop()
            return _f32({0x8B: abs(a), 0x8C: -a,
                         0x8D: float(math.ceil(a)),
                         0x8E: float(math.floor(a)),
                         0x8F: float(math.trunc(a)),
                         0x90: float(round(a)),
                         0x91: math.sqrt(a) if a >= 0 else math.nan}[op])
        if 0x92 <= op <= 0x98:                    # f32 binary
            b, a = stack.pop(), stack.pop()
            return _f32({0x92: a + b, 0x93: a - b, 0x94: a * b,
                         0x95: (a / b) if b != 0 else
                         (math.inf if a > 0 else
                          (-math.inf if a < 0 else math.nan)),
                         0x96: min(a, b), 0x97: max(a, b),
                         0x98: math.copysign(abs(a), b)}[op])
        if 0x99 <= op <= 0x9F:                    # f64 unary
            a = stack.pop()
            return {0x99: abs(a), 0x9A: -a,
                    0x9B: float(math.ceil(a)),
                    0x9C: float(math.floor(a)),
                    0x9D: float(math.trunc(a)),
                    0x9E: float(round(a)),
                    0x9F: math.sqrt(a) if a >= 0 else math.nan}[op]
        if 0xA0 <= op <= 0xA6:                    # f64 binary
            b, a = stack.pop(), stack.pop()
            return {0xA0: a + b, 0xA1: a - b, 0xA2: a * b,
                    0xA3: (a / b) if b != 0 else
                    (math.inf if a > 0 else
                     (-math.inf if a < 0 else math.nan)),
                    0xA4: min(a, b), 0xA5: max(a, b),
                    0xA6: math.copysign(abs(a), b)}[op]

        # conversions ----------------------------------------------------
        if op == 0xA7:                            # i32.wrap_i64
            return _wrap32(stack.pop())
        if op in (0xA8, 0xAA):                    # i32.trunc_f32/f64_s
            return _wrap32(_trunc(stack.pop(), -(1 << 31), (1 << 31) - 1,
                                  "i32.trunc_s"))
        if op in (0xA9, 0xAB):                    # i32.trunc_f32/f64_u
            return _trunc(stack.pop(), 0, (1 << 32) - 1, "i32.trunc_u")
        if op == 0xAC:                            # i64.extend_i32_s
            return _wrap64(_sign32(stack.pop()))
        if op == 0xAD:                            # i64.extend_i32_u
            return _wrap32(stack.pop())
        if op in (0xAE, 0xB0):                    # i64.trunc_f32/f64_s
            return _wrap64(_trunc(stack.pop(), -(1 << 63), (1 << 63) - 1,
                                  "i64.trunc_s"))
        if op in (0xAF, 0xB1):                    # i64.trunc_f32/f64_u
            return _trunc(stack.pop(), 0, (1 << 64) - 1, "i64.trunc_u")
        if op in (0xB2, 0xB4):                    # f32.convert_i32/i64_s
            return _f32(float(_sign32(stack.pop()) if op == 0xB2
                              else _sign64(stack.pop())))
        if op in (0xB3, 0xB5):                    # f32.convert_u
            return _f32(float(_wrap32(stack.pop()) if op == 0xB3
                              else _wrap64(stack.pop())))
        if op == 0xB6:                            # f32.demote_f64
            return _f32(stack.pop())
        if op in (0xB7, 0xB9):                    # f64.convert_i32/i64_s
            return float(_sign32(stack.pop()) if op == 0xB7
                         else _sign64(stack.pop()))
        if op in (0xB8, 0xBA):                    # f64.convert_u
            return float(_wrap32(stack.pop()) if op == 0xB8
                         else _wrap64(stack.pop()))
        if op == 0xBB:                            # f64.promote_f32
            return float(stack.pop())
        if op == 0xBC:                            # i32.reinterpret_f32
            return struct.unpack("<I", struct.pack("<f", stack.pop()))[0]
        if op == 0xBD:                            # i64.reinterpret_f64
            return struct.unpack("<Q", struct.pack("<d", stack.pop()))[0]
        if op == 0xBE:                            # f32.reinterpret_i32
            return struct.unpack("<f", struct.pack("<I",
                                                   _wrap32(stack.pop())))[0]
        if op == 0xBF:                            # f64.reinterpret_i64
            return struct.unpack("<d", struct.pack("<Q",
                                                   _wrap64(stack.pop())))[0]
        if op == 0xC0:                            # i32.extend8_s
            return _wrap32(struct.unpack(
                "<b", struct.pack("<B", _wrap32(stack.pop()) & 0xFF))[0])
        if op == 0xC1:                            # i32.extend16_s
            return _wrap32(struct.unpack(
                "<h", struct.pack("<H", _wrap32(stack.pop()) & 0xFFFF))[0])
        if op == 0xC2:                            # i64.extend8_s
            return _wrap64(struct.unpack(
                "<b", struct.pack("<B", _wrap64(stack.pop()) & 0xFF))[0])
        if op == 0xC3:                            # i64.extend16_s
            return _wrap64(struct.unpack(
                "<h", struct.pack("<H", _wrap64(stack.pop()) & 0xFFFF))[0])
        if op == 0xC4:                            # i64.extend32_s
            return _wrap64(_sign32(stack.pop()))

        raise WasmError(f"unsupported numeric opcode 0x{op:02x}")

    # -- SIMD (v128) -------------------------------------------------------

    def _simd(self, ins: tuple, stack: list) -> None:
        """Execute one 0xFD-prefixed op.  v128 values are 16-byte bytes
        on the stack; lane math runs on numpy views of them."""
        sub = ins[0] - 0xFD00
        mem = self.mem

        def ld(addr: int, n: int) -> bytes:
            if addr < 0 or addr + n > len(mem):
                raise Trap("out-of-bounds memory access")
            return bytes(mem[addr:addr + n])

        def stv(addr: int, data: bytes) -> None:
            if addr < 0 or addr + len(data) > len(mem):
                raise Trap("out-of-bounds memory access")
            mem[addr:addr + len(data)] = data

        # ---- memory ------------------------------------------------------
        if sub == 0:                              # v128.load
            stack.append(ld(_wrap32(stack.pop()) + ins[2], 16))
        elif 1 <= sub <= 6:                       # load-extend 8 bytes
            src, dst = (("<i1", "<i2"), ("<u1", "<u2"),
                        ("<i2", "<i4"), ("<u2", "<u4"),
                        ("<i4", "<i8"), ("<u4", "<u8"))[sub - 1]
            raw = ld(_wrap32(stack.pop()) + ins[2], 8)
            stack.append(np.frombuffer(raw, src).astype(dst).tobytes())
        elif 7 <= sub <= 10:                      # loadN_splat
            n = 1 << (sub - 7)
            stack.append(ld(_wrap32(stack.pop()) + ins[2], n) * (16 // n))
        elif sub == 11:                           # v128.store
            v = stack.pop()
            stv(_wrap32(stack.pop()) + ins[2], v)
        elif sub in (92, 93):                     # load32_zero/load64_zero
            n = 4 if sub == 92 else 8
            stack.append(ld(_wrap32(stack.pop()) + ins[2], n)
                         + b"\x00" * (16 - n))
        elif 84 <= sub <= 87:                     # loadN_lane
            n = 1 << (sub - 84)
            lane = ins[3]
            v = bytearray(stack.pop())
            v[lane * n:(lane + 1) * n] = ld(
                _wrap32(stack.pop()) + ins[2], n)
            stack.append(bytes(v))
        elif 88 <= sub <= 91:                     # storeN_lane
            n = 1 << (sub - 88)
            lane = ins[3]
            v = stack.pop()
            stv(_wrap32(stack.pop()) + ins[2],
                v[lane * n:(lane + 1) * n])
        # ---- const / lane shuffles --------------------------------------
        elif sub == 12:                           # v128.const
            stack.append(ins[1])
        elif sub == 13:                           # i8x16.shuffle
            b2 = stack.pop()
            a = stack.pop()
            both = a + b2
            stack.append(bytes(both[i] for i in ins[1]))
        elif sub == 14:                           # i8x16.swizzle
            s = stack.pop()
            a = stack.pop()
            stack.append(bytes(a[i] if i < 16 else 0 for i in s))
        elif 15 <= sub <= 18:                     # int splats
            dt, mask, n = (("<u1", 0xFF, 16), ("<u2", 0xFFFF, 8),
                           ("<u4", 0xFFFFFFFF, 4),
                           ("<u8", (1 << 64) - 1, 2))[sub - 15]
            stack.append(np.full(n, int(stack.pop()) & mask,
                                 dt).tobytes())
        elif sub in (19, 20):                     # float splats
            dt, n = ("<f4", 4) if sub == 19 else ("<f8", 2)
            stack.append(np.full(n, float(stack.pop()), dt).tobytes())
        elif 21 <= sub <= 34:                     # extract/replace lane
            self._simd_lane(sub, ins[1], stack)
        # ---- comparisons / bitwise --------------------------------------
        elif sub in _SIMD_CMP:
            dt, nm = _SIMD_CMP[sub]
            b_ = np.frombuffer(stack.pop(), dt)
            a_ = np.frombuffer(stack.pop(), dt)
            cond = {"eq": a_ == b_, "ne": a_ != b_, "lt": a_ < b_,
                    "gt": a_ > b_, "le": a_ <= b_, "ge": a_ >= b_}[nm]
            lanes = "<i" + (dt[2] if dt[1] != "f"
                            else ("4" if dt == "<f4" else "8"))
            stack.append(np.where(cond, -1, 0).astype(lanes).tobytes())
        elif sub == 77:                           # v128.not
            x = int.from_bytes(stack.pop(), "little")
            stack.append((~x & ((1 << 128) - 1)).to_bytes(16, "little"))
        elif 78 <= sub <= 81:                     # and/andnot/or/xor
            b_ = int.from_bytes(stack.pop(), "little")
            a_ = int.from_bytes(stack.pop(), "little")
            full = (1 << 128) - 1
            r = {78: a_ & b_, 79: a_ & (~b_ & full), 80: a_ | b_,
                 81: a_ ^ b_}[sub]
            stack.append(r.to_bytes(16, "little"))
        elif sub == 82:                           # bitselect
            c = int.from_bytes(stack.pop(), "little")
            b_ = int.from_bytes(stack.pop(), "little")
            a_ = int.from_bytes(stack.pop(), "little")
            stack.append(((a_ & c) | (b_ & ~c & ((1 << 128) - 1)))
                         .to_bytes(16, "little"))
        elif sub == 83:                           # v128.any_true
            stack.append(int(stack.pop() != b"\x00" * 16))
        # ---- integer lane math ------------------------------------------
        elif sub in _SIMD_IBIN:
            dt, nm = _SIMD_IBIN[sub]
            b_ = np.frombuffer(stack.pop(), dt)
            a_ = np.frombuffer(stack.pop(), dt)
            if nm in ("add", "sub", "mul"):
                with np.errstate(over="ignore"):
                    r = {"add": a_ + b_, "sub": a_ - b_,
                         "mul": a_ * b_}[nm]
            elif nm in ("add_sat", "sub_sat"):
                wide = np.int32 if dt[2] in "12" else np.int64
                info = np.iinfo(dt[1:])
                w = (a_.astype(wide) + b_.astype(wide)) if nm[0] == "a" \
                    else (a_.astype(wide) - b_.astype(wide))
                r = np.clip(w, info.min, info.max).astype(dt)
            elif nm == "avgr":
                r = ((a_.astype(np.uint32) + b_.astype(np.uint32) + 1)
                     // 2).astype(dt)
            else:                                 # min / max
                r = (np.minimum if nm == "min" else np.maximum)(a_, b_)
            stack.append(r.astype(dt).tobytes())
        elif sub in _SIMD_IUN:
            dt, nm = _SIMD_IUN[sub]
            a_ = np.frombuffer(stack.pop(), dt)
            if nm == "abs":
                with np.errstate(over="ignore"):
                    r = np.abs(a_)                # INT_MIN wraps (spec)
            elif nm == "neg":
                with np.errstate(over="ignore"):
                    r = (0 - a_).astype(dt)
            else:                                 # popcnt (u8 lanes)
                r = np.unpackbits(a_).reshape(16, 8).sum(1).astype(dt)
            stack.append(r.astype(dt).tobytes())
        elif sub in _SIMD_ALLTRUE:
            a_ = np.frombuffer(stack.pop(), _SIMD_ALLTRUE[sub])
            stack.append(int(bool((a_ != 0).all())))
        elif sub in _SIMD_BITMASK:
            a_ = np.frombuffer(stack.pop(), _SIMD_BITMASK[sub])
            stack.append(int(sum(1 << i for i, t
                                 in enumerate(a_ < 0) if t)))
        elif sub in _SIMD_SHIFT:
            dt, nm = _SIMD_SHIFT[sub]
            bits = int(dt[2]) * 8
            k = _wrap32(stack.pop()) % bits
            a_ = np.frombuffer(stack.pop(), dt)
            with np.errstate(over="ignore"):
                r = (a_ << k) if nm == "shl" else (a_ >> k)
            stack.append(r.astype(dt).tobytes())
        elif sub == 186:                          # i32x4.dot_i16x8_s
            b_ = np.frombuffer(stack.pop(), "<i2").astype(np.int32)
            a_ = np.frombuffer(stack.pop(), "<i2").astype(np.int32)
            stack.append((a_ * b_).reshape(4, 2).sum(1)
                         .astype("<i4").tobytes())
        elif sub in _SIMD_NARROW:
            src, dst = _SIMD_NARROW[sub]
            info = np.iinfo(dst[1:])
            b_ = np.frombuffer(stack.pop(), src)
            a_ = np.frombuffer(stack.pop(), src)
            r = np.clip(np.concatenate([a_, b_]), info.min, info.max)
            stack.append(r.astype(dst).tobytes())
        elif sub in _SIMD_EXTEND:
            src, dst, half = _SIMD_EXTEND[sub]
            a_ = np.frombuffer(stack.pop(), src)
            n = len(a_) // 2
            part = a_[:n] if half == "low" else a_[n:]
            stack.append(part.astype(dst).tobytes())
        # ---- float lane math --------------------------------------------
        elif sub in _SIMD_FUN:
            dt, nm = _SIMD_FUN[sub]
            a_ = np.frombuffer(stack.pop(), dt)
            with np.errstate(invalid="ignore"):
                r = {"ceil": np.ceil, "floor": np.floor,
                     "trunc": np.trunc, "nearest": np.rint,
                     "abs": np.abs, "neg": np.negative,
                     "sqrt": np.sqrt}[nm](a_)
            stack.append(r.astype(dt).tobytes())
        elif sub in _SIMD_FBIN:
            dt, nm = _SIMD_FBIN[sub]
            b_ = np.frombuffer(stack.pop(), dt)
            a_ = np.frombuffer(stack.pop(), dt)
            with np.errstate(invalid="ignore", divide="ignore"):
                if nm == "pmin":
                    r = np.where(b_ < a_, b_, a_)
                elif nm == "pmax":
                    r = np.where(a_ < b_, b_, a_)
                else:
                    r = {"add": a_ + b_, "sub": a_ - b_, "mul": a_ * b_,
                         "div": a_ / b_, "min": np.minimum(a_, b_),
                         "max": np.maximum(a_, b_)}[nm]
            stack.append(r.astype(dt).tobytes())
        # ---- conversions ------------------------------------------------
        elif sub == 94:                           # f32x4.demote_f64x2_zero
            a_ = np.frombuffer(stack.pop(), "<f8").astype("<f4")
            stack.append(a_.tobytes() + b"\x00" * 8)
        elif sub == 95:                           # f64x2.promote_low_f32x4
            a_ = np.frombuffer(stack.pop(), "<f4")[:2].astype("<f8")
            stack.append(a_.tobytes())
        elif sub in (248, 249, 252, 253):         # trunc_sat variants
            src = "<f4" if sub in (248, 249) else "<f8"
            signed = sub in (248, 252)
            a_ = np.frombuffer(stack.pop(), src).astype(np.float64)
            a_ = np.where(np.isnan(a_), 0.0, a_)
            lo, hi = ((-2**31, 2**31 - 1) if signed else (0, 2**32 - 1))
            r = np.clip(np.trunc(a_), lo, hi)
            r = r.astype("<i4" if signed else "<u4")
            if sub in (252, 253):                 # _zero: 2 lanes + zeros
                stack.append(r.tobytes() + b"\x00" * 8)
            else:
                stack.append(r.tobytes())
        elif sub in (250, 251):                   # f32x4.convert_i32x4
            dt = "<i4" if sub == 250 else "<u4"
            a_ = np.frombuffer(stack.pop(), dt).astype("<f4")
            stack.append(a_.tobytes())
        elif sub in (254, 255):                   # f64x2.convert_low_i32x4
            dt = "<i4" if sub == 254 else "<u4"
            a_ = np.frombuffer(stack.pop(), dt)[:2].astype("<f8")
            stack.append(a_.tobytes())
        else:                                     # pragma: no cover
            raise WasmError(f"unsupported SIMD opcode 0xfd {sub}")

    def _simd_lane(self, sub: int, lane: int, stack: list) -> None:
        """extract_lane / replace_lane family (subs 21-34)."""
        spec = {
            21: ("<i1", "xs"), 22: ("<u1", "xu"), 23: ("<u1", "r"),
            24: ("<i2", "xs"), 25: ("<u2", "xu"), 26: ("<u2", "r"),
            27: ("<i4", "xs"), 28: ("<u4", "r"),
            29: ("<i8", "xs64"), 30: ("<u8", "r"),
            31: ("<f4", "xf"), 32: ("<f4", "rf"),
            33: ("<f8", "xf"), 34: ("<f8", "rf"),
        }[sub]
        dt, kind = spec
        if kind.startswith("x"):                  # extract
            v = np.frombuffer(stack.pop(), dt)
            x = v[lane]
            if kind == "xs":
                stack.append(_wrap32(int(x)))
            elif kind == "xu":
                stack.append(int(x))
            elif kind == "xs64":
                stack.append(_wrap64(int(x)))
            else:
                stack.append(float(x))
        else:                                     # replace
            x = stack.pop()
            v = np.frombuffer(stack.pop(), dt).copy()
            if kind == "rf":
                v[lane] = float(x)
            else:
                mask = (1 << (int(dt[2]) * 8)) - 1
                v[lane] = int(x) & mask
            stack.append(v.tobytes())


def instantiate(data: bytes,
                host: Optional[dict[tuple[str, str], Callable]] = None
                ) -> Instance:
    return Instance(decode_module(data), host or {})
