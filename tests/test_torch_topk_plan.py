"""The fused top-k kernel's launch plan (``_topk_plan``), a pure
function the CPU can check: every tile it picks fits a block's shared
memory on the H100 at any k, and the searcher's widest dispatch
(Q = 256 at k = 128) reads the lane at most twice."""
import re
from pathlib import Path

import pytest

from libsplinter_tpu_torch.ops.similarity import (
    H100_SMS, TOPK_SMEM_BYTES, TOPK_TILES, _topk_plan, _topk_smem)

CSRC = Path(__file__).resolve().parent.parent / "libsplinter_tpu_torch" \
    / "csrc"


@pytest.mark.parametrize("nq", [1, 8, 20, 32, 129, 256, 300])
def test_topk_plan_fits_the_budget(nq):
    n = 1 << 20
    tq, nblk = _topk_plan(n, nq)
    assert tq in TOPK_TILES
    assert _topk_smem(tq) <= TOPK_SMEM_BYTES   # the lists are not in it
    assert 1 <= nblk <= -(-n // TOPK_TILES[tq][0])
    passes = -(-nq // tq)
    assert tq >= nq or tq == max(TOPK_TILES)
    if nq <= 256:
        assert passes <= 2                      # the lane read at most twice
    assert nblk * passes >= H100_SMS            # every SM has a block
    # the searcher's bucket under load: one pass over the lane, one block
    # an SM
    assert _topk_plan(n, 256) == (256, H100_SMS)
    # a lane shorter than the blocks asked for: one block per row tile
    assert _topk_plan(300, 8)[1] == 2


def test_topk_plan_mirrors_the_kernel_geometry():
    """The plan's tiles and budgets are the kernel's own
    (csrc/topk_tile.cuh TileShape and STAGES, csrc/fused_topk.cu
    SMEM_MAX and CAP)."""
    tile = (CSRC / "topk_tile.cuh").read_text()
    shapes = {int(tq): (int(tn), int(qn), int(dk)) for tq, tn, qn, dk in
              re.findall(r"TileShape<(\d+)> \{\s*static constexpr int "
                         r"TN = (\d+), QN = (\d+), DK = (\d+);", tile)}
    assert shapes == TOPK_TILES
    assert "constexpr int STAGES = 2;" in tile
    assert "static constexpr int LD = DK + 4;" in tile
    src = (CSRC / "fused_topk.cu").read_text()
    assert f"SMEM_MAX = {TOPK_SMEM_BYTES}" in src
    assert "constexpr int CAP = 32;" in src
    assert "4 * (STAGES * Tile<TQ>::STAGE + 2 * TQ * CAP + 5 * TQ)" in src
