"""On the card: the control (the reference in the next precision down,
in the program's place) fails the limits a run is held to, at a size a
test run holds: full widths, fewer layers and texts."""
import pytest

from benchmark import control
from benchmark.harness import spec


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nomic-v1.5-ingest-docs",
                                  "e5-large-v2-ingest-chunks"])
def test_fp8_reference_fails_an_ingest_limit(name, cuda):
    cell = spec.load_cell(name)
    layers = "n_layer" if "n_layer" in cell.config else "num_hidden_layers"
    cell.config = dict(cell.config, **{layers: 4})
    got = control.ingest_control(cell, 2**31 + 1, cuda, n_texts=16)
    lim = cell.workload["check"]
    assert got["max_abs_err"] > lim["max_abs_err"] \
        or got["cos_dist"] > lim["cos_dist"]

