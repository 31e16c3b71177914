"""Device selection for the port's entry points: the card unless the
caller asks for the CPU, and never a quiet fallback between them."""
from __future__ import annotations

import logging

import torch

log = logging.getLogger("libsplinter_tpu_torch.device")

DEVICE_CHOICES = ("cuda", "cpu")


def resolve_device(device=None) -> torch.device:
    """``cuda`` when `device` is None; raise when a CUDA device is asked
    for and PyTorch sees none (pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def apply_chip_pin(spec, device) -> torch.device:
    """The device a pinned lane runs on: the supervisor's --pin-chips
    reaches a child as SPTPU_CHIP_PIN (`spec`, a card ordinal), so e.g.
    disaggregated prefill and decode replicas land on disjoint cards.

    On a ``cuda`` device a valid ordinal N makes N the current CUDA
    device (call this before any model is built: its weights, caches
    and kernel launches then land there) and returns ``cuda:N``.
    Degrades, never fails: an unparsable spec or an ordinal past
    torch.cuda.device_count() logs a warning and returns `device`
    unchanged, so one invocation works on a multi-card host and a
    one-card box.  Never moves a lane to the CPU: on a ``cpu`` device
    the pin is ignored (and logged)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        log.info("SPTPU_CHIP_PIN=%r ignored: the lane runs on %s", spec,
                 dev)
        return dev
    try:
        ordinal = int(str(spec).strip())
    except (TypeError, ValueError):
        log.warning("SPTPU_CHIP_PIN=%r is not a device ordinal; ignoring",
                    spec)
        return dev
    count = torch.cuda.device_count()
    if not 0 <= ordinal < count:
        log.warning("SPTPU_CHIP_PIN=%d out of range (host has %d "
                    "device(s)); leaving default placement", ordinal,
                    count)
        return dev
    torch.cuda.set_device(ordinal)
    return torch.device("cuda", ordinal)


def _any_cuda(value) -> bool:
    if isinstance(value, (list, tuple)):
        return any(_any_cuda(v) for v in value)
    return bool(getattr(value, "is_cuda", False))


class DeviceFuture:
    """A result whose device work may still be in flight: the value
    (a tensor or a tuple of them) plus a CUDA event recorded on the
    current stream right after the work was queued.  is_ready() says
    whether reading it will block — the pending-future contract of
    engine/resident.py's InflightWindow.  CPU values are always
    ready."""

    __slots__ = ("value", "_event")

    def __init__(self, value):
        self.value = value
        self._event = None
        if _any_cuda(value):
            self._event = torch.cuda.Event()
            self._event.record()

    def is_ready(self) -> bool:
        return self._event is None or bool(self._event.query())
