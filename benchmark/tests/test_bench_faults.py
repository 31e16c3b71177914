"""A run whose timed path is broken underneath comes out not correct:
a tiny ingest cell on the CPU, the look for a chip skipped, and
the program's path broken at the point each fault would arise."""
import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import ingest

import cells


def _run(driver, cell, capsys):
    rc = driver.run(cell, seed=2**31 + 77, seconds=3, trace_on=False,
                    device=torch.device("cpu"), t_proc0=time.monotonic())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_an_unbroken_ingest_run_is_correct(capsys):
    out = _run(ingest, cells.tiny_ingest(), capsys)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0


def _altered(self, rows, epochs, vecs, t):          # an answer altered
    vecs = vecs.copy()
    vecs[:, 0] = -vecs[:, 0]
    return _commit(self, rows, epochs, vecs, t)


def _half(self, rows, epochs, vecs, t):             # half of a batch left out
    vecs = vecs.copy()
    vecs[len(vecs) // 2:] = vecs[: len(vecs) - len(vecs) // 2][::-1] \
        if len(vecs) > 1 else -vecs[:]
    return _commit(self, rows, epochs, vecs, t)


def _unchanged(self, rows, epochs, vecs, *a, **kw):  # the state unchanged
    return np.zeros(len(rows), np.int32)


_commit = None


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_a_broken_ingest_run_is_not_correct(fault, monkeypatch, capsys):
    global _commit
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.store import Store

    _commit = Embedder._commit_batch
    if fault == "unchanged":
        monkeypatch.setattr(Store, "vec_commit_batch", _unchanged)
    else:
        monkeypatch.setattr(Embedder, "_commit_batch",
                            {"altered": _altered, "half": _half}[fault])
    cell = cells.tiny_ingest()
    cell.traffic = dict(cell.traffic, grace_s=5)
    out = _run(ingest, cell, capsys)
    assert not out["correct"]

