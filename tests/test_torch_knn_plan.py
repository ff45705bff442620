"""The launch plan of the resident k-NN kernel (ssad_tpu_torch/ops/knn.py
``_plan``, csrc/knn.cu), checked without a card: every bank row falls to
exactly one CTA of a cluster, the cluster is at most 16 CTAs, every query
falls in a tile, and a CTA's shared memory fits Hopper's 227 KB even for
2048-wide rows."""

import pytest

from ssad_tpu_torch.ops import knn

SMEM_LIMIT = 227 * 1024


@pytest.mark.parametrize("n, m", [(8, 700), (300, 700), (37, 1000), (8, 20), (5, 3), (129, 4096)])
@pytest.mark.parametrize("d", [100, 512, 2048])
def test_plan_covers_every_row_once(n, m, d):
    plan = knn._plan(n, m, d)
    assert 1 <= plan.cluster <= knn.MAX_CLUSTER
    covered = [0] * m
    for rank in range(plan.cluster):
        begin = min(m, rank * plan.rows_per_cta)
        for row in range(begin, min(m, begin + plan.rows_per_cta)):
            covered[row] += 1
    assert covered == [1] * m
    assert plan.tiles * plan.query_tile >= n > (plan.tiles - 1) * plan.query_tile
    assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_spreads_the_image_bank():
    """The 700-row bank of 512-wide rows goes across a full cluster, at
    most about 100 KB of it per CTA; the fit's 300 queries take 10 tiles
    of 32, a request batch's 8 one tile."""
    serve, fit = knn._plan(8, 700, 512), knn._plan(300, 700, 512)
    assert serve.cluster == fit.cluster == knn.MAX_CLUSTER
    assert serve.rows_per_cta * 512 * 4 <= 100 * 1024
    assert (serve.query_tile, serve.tiles, fit.query_tile, fit.tiles) == (8, 1, 32, 10)
    with pytest.raises(ValueError):
        knn._plan(0, 700, 512)
