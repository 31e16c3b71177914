"""splint for the port — the repo-native static analysis over
`libsplinter_tpu_torch/`.

Two rule families guard the invariants the serving stack's
correctness rests on:

- **Registry-sync (SPL1xx)** — the port's `engine/protocol.py` parsed
  into a canonical registry (label bits, stage tuples, well-known
  keys) plus the discovered `fault()` sites; rules assert no
  label-bit collisions, no raw bit literals outside protocol.py,
  every fault site documented + chaos-reachable, `cli/metrics.py` in
  sync with the published heartbeat keys, and the doc tables derived
  from the registry.
- **Torch dispatch hazards (SPL2xx)** — no blocking host sync inside
  a drain loop, no unseeded randomness in fault paths.

Entry points: `python -m libsplinter_tpu_torch.cli lint` (cli/lint.py)
and `runner.scan()` (in-process).  Everything under `analysis/` is
stdlib-only (`ast`): no torch, no jax, nothing of `libsplinter_tpu`.
The JAX package's splint (`libsplinter_tpu/analysis/`) keeps its own
registry and catalog; nothing here reads or writes them.
"""
from .core import Finding, RULES, Rule                   # noqa: F401
from .registry import (ProtocolRegistry, extract_registry,   # noqa: F401
                       fault_sites, FAULT_SITE_DOCS)
from .runner import Report, build_context, scan, update_baseline  # noqa: F401,E501
