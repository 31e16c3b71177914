"""Serving daemons over the store's event bus: the embedding daemon
(embedder.py), the query-coalescing search daemon (searcher.py) and the
completion daemon (completer.py), sharing one coordination contract
(protocol.py, a byte-identical copy of the JAX package's, so torch and
JAX daemons can share one store)."""
from . import protocol

__all__ = ["protocol", "Completer", "Searcher", "daemon_live",
           "submit_search"]

_SEARCHER_API = ("Searcher", "daemon_live", "submit_search")


def __getattr__(name):
    # lazy: `python -m libsplinter_tpu_torch.engine.searcher` must not
    # find the module pre-imported by its own package (runpy warns),
    # and protocol-only importers skip the daemon modules entirely
    if name == "Completer":
        from .completer import Completer
        return Completer
    if name in _SEARCHER_API:
        from . import searcher
        return getattr(searcher, name)
    raise AttributeError(name)
