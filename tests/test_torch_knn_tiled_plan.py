"""The launch plan of the streaming bf16x3 k-NN kernel
(ssad_tpu_torch/ops/knn.py ``_tiled_plan``, csrc/knn_tiled.cu), checked
without a card: every (query tile, bank tile) pair falls to exactly one
CTA, a CTA's shared memory (from the kernel source's own constants) fits
Hopper's 227 KB, and at the patch path's request shape the last wave
leaves under a tenth of the SMs' time idle."""

import re

import pytest

from ssad_tpu_torch.ops import _cuda, knn

SMEM_LIMIT = 227 * 1024
SMS = 132  # H100 SXM
REQUEST, FIT = (6728, 29435), (12615, 29435)  # 8 x 841 windows; the 70/30 fit of 50 x 841


def kernel_constants() -> dict:
    """The file-scope ``constexpr int`` values of csrc/knn_tiled.cu, in
    source order (the macro-set group depth left out)."""
    src = (_cuda.CSRC_DIR / "knn_tiled.cu").read_text()
    values = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        if "SSAD_" not in expr:
            values[name] = eval(expr, {"__builtins__": {}}, dict(values))  # noqa: S307
    return values


def idle_share(plan, d: int = 512) -> float:
    """Idle share of the SMs' time in the plan's own model at one CTA per
    SM: a CTA costs its tiles' 64-deep slices plus one."""
    slices = -(-d // 64)
    jobs = knn._tiled_jobs(plan.query_tiles, plan.bank_tiles, plan.tiles_per_split, slices)
    span = knn._makespan(jobs, SMS)
    return 1.0 - sum(count * duration for count, duration in jobs) / (SMS * span)


@pytest.mark.parametrize("n, m", [REQUEST, FIT, (40, 2500), (3, 1030), (130, 129)])
def test_plan_covers_every_tile_pair_once(n, m):
    plan = knn._tiled_plan(n, m, 512, SMS)
    assert plan.query_tiles == -(-n // 128) and plan.bank_tiles == -(-m // 128)
    covered = {}
    for q_tile in range(plan.query_tiles):
        for split in range(plan.splits):
            begin = split * plan.tiles_per_split
            end = min(plan.bank_tiles, begin + plan.tiles_per_split)
            assert end > begin, "every split holds at least one bank tile"
            for b_tile in range(begin, end):
                covered[q_tile, b_tile] = covered.get((q_tile, b_tile), 0) + 1
    assert len(covered) == plan.query_tiles * plan.bank_tiles
    assert set(covered.values()) == {1}
    assert 0.0 <= idle_share(plan) < 1.0


def test_kernel_constants_fit_one_cta_in_shared_memory():
    """The tile sizes the wrapper assumes are the kernel's, and a CTA's
    ring of stages (plus its alignment slack and mbarriers) fits."""
    c = kernel_constants()
    assert (c["kBQ"], c["kBN"], c["kBK"]) == (knn._TILE_Q, knn._TILE_M, knn._TILE_D)
    # qh, ql, bh, bl slices in bf16
    assert c["kStageBytes"] == (2 * c["kBQ"] + 2 * c["kBN"]) * c["kBK"] * 2
    assert c["kSmemBytes"] + 2 * 8 * c["kStages"] <= SMEM_LIMIT


def test_plan_keeps_the_request_shapes_tail_small():
    """53 query tiles x 230 bank tiles: the chosen splits leave under 10 %
    of the SMs' time idle in the plan's model; the fit's 99 query tiles
    fill whole waves."""
    request, fit = knn._tiled_plan(*REQUEST, 512, SMS), knn._tiled_plan(*FIT, 512, SMS)
    assert idle_share(request) < 0.10 and idle_share(fit) < 0.10
    assert (request.splits, request.tiles_per_split) == (15, 16)
    assert (fit.splits, fit.tiles_per_split) == (4, 58)
    # the previous choice, about eight waves of two CTAs per SM (39 splits
    # of 6 tiles), finishes later in the same model at one CTA per SM
    chosen = knn._makespan([(53 * 14, 16 * 8 + 1), (53, 6 * 8 + 1)], SMS)
    previous = knn._makespan([(53 * 38, 6 * 8 + 1), (53, 2 * 8 + 1)], SMS)
    assert chosen < previous


def test_makespan_hands_jobs_to_the_earliest_free_sm():
    assert knn._makespan([(4, 2.0)], 2) == 4.0
    assert knn._makespan([(3, 2.0), (1, 1.0)], 2) == 4.0
    assert knn._makespan([(2, 3.0), (4, 1.0)], 3) == 4.0


def test_plan_refuses_empty_problems():
    with pytest.raises(ValueError):
        knn._tiled_plan(0, 2500, 512, SMS)
    with pytest.raises(ValueError):
        knn._tiled_plan(40, 2500, 512, 0)
