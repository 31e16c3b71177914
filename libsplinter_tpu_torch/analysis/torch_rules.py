"""Torch dispatch-hazard rules (SPL2xx) for the port.

The port's lanes keep the device busy by not waiting on it: a drain
loop enqueues work and resolves results through its pending/inflight
paths.  One blocking host sync inside a drain loop (a `.item()`, a
`torch.cuda.synchronize()`, a scalar coercion of a fresh result)
stalls the lane on the device on every pass.  Fault paths must also
draw randomness only from seeded instances, or the chaos drills stop
being deterministic under SPTPU_FAULT_SEED.  These rules encode both
absences so a refactor of the lanes cannot quietly reintroduce them.

The JAX package's SPL202 (donated buffer read after donation), SPL203
(paged-pool jit program without an `out_shardings` pin) and SPL205
(jit program not registered with the devtime plane) have no
counterpart here: PyTorch has no buffer donation, the port runs no
GSPMD program whose output sharding could be left to the compiler,
and its kernels are launched eagerly through wrappers that count
their own launches (`ops/_cuda.py` LAUNCHES), with no compiled
program to register.

All checks are AST heuristics tuned for this codebase's idioms; a
justified inline suppression (see core.py) is the designed escape for
the intentional cases.
"""
from __future__ import annotations

import ast

from .core import Context, Finding, rule

# drain/run-loop function names whose bodies must not block on device
DRAIN_FN_NAMES = {"run_once", "run_continuous", "_service"}
DRAIN_FN_PREFIXES = ("_dispatch_",)


def _is_drain_fn(name: str) -> bool:
    return name in DRAIN_FN_NAMES or \
        any(name.startswith(p) for p in DRAIN_FN_PREFIXES)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (`torch.cuda.synchronize`,
    `self._ring_fn`); '' when it isn't a plain name chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _iter_drain_functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_drain_fn(node.name):
            yield node


# --- SPL201: blocking host sync in a drain loop ---------------------------

_NP_ROOTS = {"np", "numpy"}
# tensor methods that copy to the host and so wait for the device
_FETCH_METHODS = ("item", "tolist", "cpu", "numpy")


@rule("SPL201", "dispatch", "blocking host sync inside a drain loop",
      "`.item()` / `.tolist()` / `.cpu()` / `.numpy()` / "
      "`torch.cuda.synchronize()` / `<stream or event>.synchronize()` "
      "/ `np.asarray|np.array(<fresh compute>)` / "
      "`float|int(<fresh compute>)` inside "
      "run_once/run_continuous/_service/_dispatch_* blocks the lane "
      "on the device")
def check_host_sync_in_drain(ctx: Context) -> list[Finding]:
    out = []
    for rel, sf in ctx.engine_files():
        for fn in _iter_drain_functions(sf.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _dotted(node.func)
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "synchronize":
                    out.append(Finding(
                        rel, node.lineno, "SPL201",
                        f"{name or 'synchronize'}() in {fn.name}() "
                        f"waits for the device on the drain path — "
                        f"resolve through the pending/inflight path "
                        f"instead"))
                    continue
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _FETCH_METHODS and \
                        not node.args:
                    out.append(Finding(
                        rel, node.lineno, "SPL201",
                        f".{node.func.attr}() in {fn.name}() copies "
                        f"a device result to the host — a blocking "
                        f"fetch on the drain path"))
                    continue
                # np.asarray(<call>) — materializing a fresh compute
                # result is a hidden device->host fence
                if name.split(".")[0] in _NP_ROOTS and \
                        name.endswith(("asarray", "array")) and \
                        node.args and \
                        isinstance(node.args[0], ast.Call):
                    inner = _dotted(node.args[0].func)
                    if inner.split(".")[0] not in _NP_ROOTS:
                        out.append(Finding(
                            rel, node.lineno, "SPL201",
                            f"np.asarray({inner or 'call'}(...)) in "
                            f"{fn.name}() forces the result to host "
                            f"— a blocking fetch on the drain path"))
                    continue
                # float(<call>) / int(<call>) — scalar coercion of a
                # fresh result is a one-element device fetch
                if isinstance(node.func, ast.Name) and \
                        node.func.id in ("float", "int") and \
                        node.args and \
                        isinstance(node.args[0], ast.Call):
                    inner = _dotted(node.args[0].func)
                    root = inner.split(".")[0]
                    if root not in _NP_ROOTS | {"len", "time", "os",
                                                "round", "min", "max"}:
                        out.append(Finding(
                            rel, node.lineno, "SPL201",
                            f"{node.func.id}({inner or 'call'}(...))"
                            f" in {fn.name}() synchronously fetches "
                            f"a device scalar on the drain path"))
    return out


# --- SPL204: unseeded randomness in fault paths ---------------------------

# torch draws that take their numbers from the global generator unless
# they are given an explicit `generator=` (`rand` also covers randn,
# randint, randperm and the `*_like` forms)
_TORCH_DRAWS = ("rand", "multinomial", "bernoulli", "normal")


def _torch_draw(name: str) -> bool:
    root, _, fn = name.partition(".")
    return root == "torch" and "." not in fn and fn.startswith(
        _TORCH_DRAWS)


def _calls_fault(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            nm = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else "")
            if nm == "fault":
                return True
    return False


@rule("SPL204", "dispatch", "unseeded randomness in a fault path",
      "functions containing a `fault()` site must not draw from the "
      "global `random` / `np.random` module RNG, nor from torch's "
      "global generator (`torch.rand*` / `randn*` / `randint` / "
      "`randperm` / `multinomial` / `bernoulli` / `normal` without "
      "`generator=`) — chaos drills are deterministic under "
      "SPTPU_FAULT_SEED only if every draw comes from a seeded "
      "instance")
def check_fault_path_nondeterminism(ctx: Context) -> list[Finding]:
    out = []
    for rel, sf in ctx.engine_files():
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if not _calls_fault(fn):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _dotted(node.func)
                if name.startswith("random.") and \
                        name != "random.Random":
                    out.append(Finding(
                        rel, node.lineno, "SPL204",
                        f"{name}() in {fn.name}() draws from the "
                        f"global RNG inside a fault path — use the "
                        f"seeded instance (SPTPU_FAULT_SEED "
                        f"determinism)"))
                elif name.startswith("np.random.") or \
                        name.startswith("numpy.random."):
                    out.append(Finding(
                        rel, node.lineno, "SPL204",
                        f"{name}() in {fn.name}() draws from the "
                        f"global numpy RNG inside a fault path — "
                        f"use a seeded Generator"))
                elif _torch_draw(name) and \
                        not any(kw.arg == "generator"
                                for kw in node.keywords):
                    out.append(Finding(
                        rel, node.lineno, "SPL204",
                        f"{name}() in {fn.name}() draws from torch's "
                        f"global generator inside a fault path — "
                        f"pass a seeded torch.Generator"))
    return out
