"""Pixel metrics on the maps' device: one sort → ROC AUC, the optimal-F1
threshold, F1, IoU, the MVTec-official AUPRO and the plot curves.

Counterpart of ssad_tpu/evaluation/metrics_device.py:48-275, as PyTorch
ops (no TPU kernel lies here).  The host oracles in
``evaluation/metrics.py`` argsort the flattened maps once per metric in
f64; here the maps stay where they are (on the card, when they were made
there): one ``torch.sort`` of the negated scores (stable, as ``lax.sort``)
carries the positive-pixel and PRO-weight payloads through its indices,
every curve statistic is a ``cumsum`` over the sorted order, and only
scalars and ``CURVE_POINTS``-point curves come back to the host.

Ties are resolved as the oracles resolve them: every curve point is
taken at the LAST element of each equal-score run, and the previous
run's end comes from a shifted ``torch.cummax`` (the cumulative sums are
nondecreasing, so the prefix max of the run-end values is the latest
run end).  Sums, ratios and the curves are f32, as in the JAX program,
so the results agree with the f64 oracles to about 1e-4
(tests/test_torch_metrics_device.py).  The JAX program pads to a power
of two to avoid recompiles; nothing is compiled here, so nothing is
padded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.evaluation.metrics import _connected_components

#: downsampled plot-curve length
CURVE_POINTS = 2048


def _prev_end_fill(values: torch.Tensor, is_end: torch.Tensor) -> torch.Tensor:
    """Per position, the value at the end of the previous equal-score run
    (0 before the first); ``values`` nondecreasing and nonnegative."""
    masked = torch.where(is_end, values, torch.zeros_like(values))
    shifted = torch.cat([torch.zeros_like(masked[:1]), masked[:-1]])
    return torch.cummax(shifted, dim=0).values


def metrics_program(scores, pos, pro, total_pos: int, total_neg: int, num_regions: int,
                    fpr_limit: float = 0.3, curve_points: int = CURVE_POINTS):
    """The fused metrics (the JAX ``_build_program``) on the inputs'
    device, from ``metric_inputs`` → (auroc, thr, f1, iou, aupro, (fpr,
    tpr, pro) curves), all tensors."""
    f32 = torch.float32
    n = scores.shape[0]
    neg_s, order = torch.sort(-scores, stable=True)
    s = -neg_s
    pos_s = pos.index_select(0, order).to(torch.int64)
    pro_s = pro.index_select(0, order)
    is_end = torch.cat([s[1:] != s[:-1], torch.ones(1, dtype=torch.bool, device=s.device)])

    tps = torch.cumsum(pos_s, 0)
    fps = torch.cumsum(1 - pos_s, 0)
    pros_cum = torch.cumsum(pro_s, 0)
    p_, n_, r_ = (float(max(v, 1)) for v in (total_pos, total_neg, num_regions))

    # ROC: trapezoids between consecutive run ends, from the (0, 0) origin
    tpr = torch.clamp(tps.to(f32) / p_, max=1.0)
    fpr = torch.clamp(fps.to(f32) / n_, max=1.0)
    tpr_prev, fpr_prev = _prev_end_fill(tpr, is_end), _prev_end_fill(fpr, is_end)
    seg = 0.5 * (tpr + tpr_prev) * (fpr - fpr_prev)
    auroc = torch.where(is_end, seg, 0.0).sum(dtype=f32)

    # PRO on the ROC's x axis, the trapezoid cut at fpr_limit with the
    # boundary point interpolated (metrics.py:trapezoid_bounded)
    pro_y = torch.clamp(pros_cum / r_, max=1.0)
    pro_prev = _prev_end_fill(pro_y, is_end)
    x0, x1, y0, y1 = fpr_prev, fpr, pro_prev, pro_y
    dx = torch.clamp(x1 - x0, min=1e-30)
    y_at_limit = y0 + (y1 - y0) * (fpr_limit - x0) / dx
    seg_full = 0.5 * (y0 + y1) * (x1 - x0)
    seg_cut = 0.5 * (y0 + y_at_limit) * (fpr_limit - x0)
    seg = torch.where(x0 >= fpr_limit, 0.0, torch.where(x1 <= fpr_limit, seg_full, seg_cut))
    aupro = torch.where(is_end, seg, 0.0).sum(dtype=f32) / fpr_limit

    # optimal-F1 threshold: scores >= t positive, so at run end i the
    # support is i + 1; of tied maxima the oracle takes the smallest
    # threshold, in this descending order the LAST argmax
    support = torch.arange(1, n + 1, device=s.device, dtype=f32)
    precision = tps.to(f32) / support
    recall = tps.to(f32) / p_
    f1_curve = (2 * precision * recall) / (precision + recall + 1e-10)
    cand = torch.where(is_end, f1_curve, -1.0)
    best = n - 1 - int(torch.argmax(cand.flip(0)))
    thr = torch.nextafter(s[best], torch.tensor(-float("inf"), device=s.device))

    # F1 / IoU at that threshold (strict >, torchmetrics semantics)
    pred = s > thr
    y = pos_s.bool()
    tp = (pred & y).sum()
    fp = (pred & ~y).sum()
    fn = (~pred & y).sum()
    denom = (2 * tp + fp + fn).to(f32)
    f1 = torch.where(denom > 0, 2 * tp.to(f32) / denom, 0.0)
    union1 = (pred | y).sum()
    inter0 = (~pred & ~y).sum()
    union0 = (~pred | ~y).sum()
    iou1 = tp.to(f32) / torch.clamp(union1, min=1).to(f32)
    iou0 = inter0.to(f32) / torch.clamp(union0, min=1).to(f32)
    w1, w0 = (union1 > 0).to(f32), (union0 > 0).to(f32)
    iou = (iou0 * w0 + iou1 * w1) / torch.clamp(w0 + w1, min=1.0)

    # curves at curve_points quantile positions (f32 index arithmetic, as
    # the JAX program's)
    step = torch.tensor(n, dtype=f32) / curve_points
    qidx = torch.clamp((torch.arange(1, curve_points + 1, dtype=f32) * step).to(torch.int64),
                       max=n - 1).to(s.device)
    curve = (fpr[qidx], tpr[qidx], pro_y[qidx])
    return auroc, thr, f1, iou, aupro, curve


@dataclasses.dataclass
class PixelMetrics:
    auroc: float
    threshold: float
    f1: float
    iou: float
    aupro: Optional[float]
    #: downsampled (fpr, tpr) / (fpr, pro) polylines for plotting
    roc: Tuple[np.ndarray, np.ndarray]
    pro: Optional[Tuple[np.ndarray, np.ndarray]]


def pro_changes(gts: np.ndarray) -> Tuple[np.ndarray, int]:
    """(per-pixel PRO increments 1/|region| on each 8-connected GT
    component, number of regions) from (N, H, W) masks, on the host."""
    gts = np.asarray(gts)
    pro = np.zeros(gts.shape, np.float32)
    num_regions = 0
    for i in range(gts.shape[0]):
        labeled, n = _connected_components(gts[i] > 0)
        if n == 0:
            continue
        num_regions += n
        sizes = np.bincount(labeled.ravel(), minlength=n + 1).astype(np.float64)
        sizes[0] = 1.0
        w = 1.0 / sizes
        w[0] = 0.0
        pro[i] = w[labeled]
    return pro, num_regions


def metric_inputs(anomaly_maps, ground_truths, with_pro: bool = True):
    """The program's inputs: (flat f32 scores on the maps' device, the
    positive pixels and the PRO weights uploaded there, total positives,
    total negatives, GT regions).  The masks' connected components are
    host work."""
    gts = np.asarray(ground_truths)
    pos_host = (gts > 0).reshape(-1)
    total_pos = int(pos_host.sum())
    total_neg = int(pos_host.size - total_pos)
    if total_pos == 0 or total_neg == 0:
        raise ValueError("pixel metrics need both positive and negative pixels")
    maps = torch.as_tensor(anomaly_maps)
    if maps.ndim == 4:
        maps = maps[:, 0]
    scores = torch.nan_to_num(maps.to(torch.float32)).reshape(-1)
    if scores.shape[0] != pos_host.size:
        raise ValueError(f"{scores.shape[0]} scores for {pos_host.size} mask pixels")
    dev = scores.device
    pos = torch.from_numpy(pos_host.astype(np.int8)).to(dev)
    if with_pro:
        pro_host, num_regions = pro_changes(gts)
        pro = torch.from_numpy(pro_host.reshape(-1)).to(dev)
    else:
        pro, num_regions = torch.zeros(scores.shape[0], device=dev), 0
    return scores, pos, pro, total_pos, total_neg, num_regions


def pixel_metrics(anomaly_maps, ground_truths, fpr_limit: float = 0.3, with_pro: bool = True,
                  curve_points: int = CURVE_POINTS) -> PixelMetrics:
    """Every pixel metric of one category on the maps' device.

    ``anomaly_maps``: (N, H, W) or (N, 1, H, W) scores, a tensor (left on
    its device) or an array (→ a CPU tensor).  ``ground_truths``: (N, H, W)
    host masks.  Needs at least one positive and one negative pixel."""
    inputs = metric_inputs(anomaly_maps, ground_truths, with_pro)
    auroc, thr, f1, iou, aupro, curve = metrics_program(*inputs, fpr_limit, curve_points)
    fpr_c, tpr_c, pro_c = (c.cpu().numpy().astype(np.float64) for c in curve)
    roc = (np.r_[0.0, fpr_c, 1.0], np.r_[0.0, tpr_c, 1.0])
    has_pro = with_pro and inputs[-1] > 0
    return PixelMetrics(
        auroc=float(auroc), threshold=float(thr), f1=float(f1), iou=float(iou),
        aupro=float(aupro) if has_pro else None, roc=roc,
        pro=(np.r_[0.0, fpr_c, 1.0], np.r_[0.0, pro_c, 1.0]) if has_pro else None,
    )
