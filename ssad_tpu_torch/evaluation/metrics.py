"""Evaluation metrics on the host: ROC/AUC, F1, the optimal threshold,
IoU, AUPRO, and the score tables.

Counterpart of ssad_tpu/evaluation/metrics.py:25-255, in numpy and scipy
(the reference's sklearn/torchmetrics semantics, metrics.py:42-228 and
tools.py:129-146): the oracles of the fused program in
``evaluation/metrics_device.py``.  Connected components come from
``scipy.ndimage.label`` (8-connected).  The JAX package writes its
tables with pandas; ``ScoreTable`` writes the same csv and LaTeX text
and the same Markdown grid (tabulate's pipe layout) without it.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# --- ROC / AUC ---------------------------------------------------------------


def roc_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) at every distinct score, descending
    thresholds — sklearn.roc_curve semantics without the collinear-point
    dropping (AUC is identical; the reference plots the curves only)."""
    y = np.asarray(labels).ravel().astype(bool)
    s = np.asarray(scores).ravel().astype(np.float64)
    order = np.argsort(-s, kind="stable")
    y = y[order]
    s = s[order]
    distinct = np.r_[np.diff(s) != 0, True]
    tps = np.cumsum(y)[distinct]
    fps = np.cumsum(~y)[distinct]
    p = max(int(y.sum()), 1)
    n = max(int((~y).sum()), 1)
    tpr = np.r_[0.0, tps / p]
    fpr = np.r_[0.0, fps / n]
    thresholds = np.r_[np.inf, s[distinct]]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Trapezoidal area under a curve given by sorted x and y values."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.trapezoid(y, x))


def auroc(labels, scores) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return auc(fpr, tpr)


# --- F1 / thresholds ---------------------------------------------------------


def f1_score(labels, scores, threshold: float) -> float:
    """Binary F1 of `scores > threshold` (torchmetrics F1Score(threshold)
    semantics, reference metrics.py:42-46).

    The comparison runs in f64: under NumPy 2's weak scalar promotion a
    float32 score array would instead cast the Python-float threshold
    DOWN to f32 — rounding optimal_f1_threshold's nextafter-below-the-
    boundary value back up onto the boundary score and silently
    excluding the boundary sample(s) it was constructed to keep."""
    y = np.asarray(labels).ravel().astype(bool)
    pred = np.asarray(scores).ravel().astype(np.float64) > threshold
    tp = np.sum(pred & y)
    fp = np.sum(pred & ~y)
    fn = np.sum(~pred & y)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def precision_recall_curve(labels, scores):
    """(precision, recall, thresholds), thresholds ascending — matches
    torchmetrics PrecisionRecallCurve as used for threshold selection
    (reference tools.py:141-146)."""
    y = np.asarray(labels).ravel().astype(bool)
    s = np.asarray(scores).ravel().astype(np.float64)
    order = np.argsort(s, kind="stable")
    y = y[order]
    s = s[order]
    total_pos = int(y.sum())
    n = len(s)
    # predictions at threshold t: scores >= t. Sweep distinct values;
    # a run of tied scores must be counted from its FIRST index (the
    # whole run satisfies >= t), not its last — indexing the last
    # under-counted tp/support whenever scores contain duplicates.
    first_of_run = np.r_[True, np.diff(s) != 0]
    idxs = np.nonzero(first_of_run)[0]
    # tail sums: positives with score >= s[i]
    pos_tail = np.cumsum(y[::-1])[::-1]
    thresholds = s[idxs]
    tp = pos_tail[idxs]
    support = n - idxs  # number predicted positive
    precision = np.where(support > 0, tp / np.maximum(support, 1), 1.0)
    recall = tp / max(total_pos, 1)
    precision = np.r_[precision, 1.0]
    recall = np.r_[recall, 0.0]
    return precision, recall, thresholds


def optimal_f1_threshold(labels, scores) -> float:
    """Threshold maximizing F1 over the PR curve (reference
    Evaluator._get_threshold, tools.py:141-146).

    The PR sweep counts ``scores >= t`` as positive, but every consumer
    binarizes with strict ``scores > threshold`` (torchmetrics
    semantics, f1_score/iou_score above) — returning the sweep's t
    verbatim would flip the boundary sample(s) to negative and report
    an F1 that never equals the optimum just selected (the reference
    inherits exactly this flip from torchmetrics).  Returning the
    nextafter-down value makes ``>`` reproduce the selected optimum
    while admitting no additional samples."""
    precision, recall, thresholds = precision_recall_curve(labels, scores)
    f1 = (2 * precision * recall) / (precision + recall + 1e-10)
    best = int(np.argmax(f1[: len(thresholds)]))
    return float(np.nextafter(thresholds[best], -np.inf))


def iou_score(labels, scores, threshold: float) -> float:
    """Macro Jaccard index over {background, defect} — torchmetrics
    JaccardIndex(num_classes=2) semantics (reference tools.py:134-137)."""
    y = np.asarray(labels).ravel() > 0
    # f64 comparison: see f1_score on NumPy-2 weak scalar promotion
    pred = np.asarray(scores).ravel().astype(np.float64) > threshold
    inter1 = np.sum(pred & y)
    union1 = np.sum(pred | y)
    iou1 = inter1 / union1 if union1 else np.nan
    inter0 = np.sum(~pred & ~y)
    union0 = np.sum(~pred | ~y)
    iou0 = inter0 / union0 if union0 else np.nan
    return float(np.nanmean([iou0, iou1]))


def _connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected labeling of a binary mask."""
    from scipy.ndimage import label as nd_label

    labeled, n = nd_label(mask, structure=np.ones((3, 3), int))
    return labeled, int(n)


def compute_pro(anomaly_maps: np.ndarray, ground_truth_maps: np.ndarray):
    """(fprs, pros) curve points, ascending, both starting at 0 and
    ending at 1 — the MVTec-AD official evaluation algorithm
    (reference metrics.py:59-161): per-GT-connected-component overlap
    accumulated through one descending sort of all pixel scores.
    """
    maps = np.asarray(anomaly_maps, np.float32)
    gts = np.asarray(ground_truth_maps)
    assert maps.shape == gts.shape, (maps.shape, gts.shape)

    num_ok = 0
    num_regions = 0
    fp_change = np.zeros(maps.shape, np.uint32)
    pro_change = np.zeros(maps.shape, np.float64)

    for i, gt in enumerate(gts):
        labeled, n = _connected_components(gt > 0)
        num_regions += n
        ok = labeled == 0
        num_ok += int(ok.sum())
        fp_change[i][ok] = 1
        for k in range(1, n + 1):
            region = labeled == k
            pro_change[i][region] = 1.0 / region.sum()

    scores = maps.ravel()
    order = np.argsort(scores, kind="stable")[::-1]
    scores_sorted = scores[order]
    # int64 cumsum: the reference asserts n_pixels < uint32 max for this
    # exact sum (metrics.py:70-71); int64 removes the overflow ceiling
    fprs = np.cumsum(fp_change.ravel()[order], dtype=np.int64).astype(np.float64) / max(num_ok, 1)
    pros = np.cumsum(pro_change.ravel()[order]) / max(num_regions, 1)

    # keep only the last point of each equal-score run
    keep = np.r_[np.diff(scores_sorted) != 0, True]
    fprs = np.clip(fprs[keep], None, 1.0)
    pros = np.clip(pros[keep], None, 1.0)
    return np.r_[0.0, fprs, 1.0], np.r_[0.0, pros, 1.0]


def trapezoid_bounded(x: np.ndarray, y: np.ndarray, x_max: Optional[float] = None) -> float:
    """Definite integral of the (x, y) curve, optionally cut at x_max
    with linear interpolation of the boundary point (reference
    metrics.py:170-228)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    finite = np.isfinite(x) & np.isfinite(y)
    x, y = x[finite], y[finite]
    correction = 0.0
    if x_max is not None:
        if x_max not in x:
            ins = int(np.searchsorted(x, x_max))
            assert 0 < ins < len(x), "x_max outside curve range"
            y_interp = y[ins - 1] + (y[ins] - y[ins - 1]) * (x_max - x[ins - 1]) / (
                x[ins] - x[ins - 1]
            )
            correction = 0.5 * (y_interp + y[ins - 1]) * (x_max - x[ins - 1])
        mask = x <= x_max
        x, y = x[mask], y[mask]
    return float(np.sum(0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1])) + correction)


def compute_aupro(fprs, pros, fpr_limit: float = 0.3) -> float:
    """Normalized area under the PRO curve up to `fpr_limit`
    (reference metrics.py:164-167)."""
    return trapezoid_bounded(fprs, pros, x_max=fpr_limit) / fpr_limit


def aupro(anomaly_maps, ground_truth_maps, fpr_limit: float = 0.3) -> float:
    fprs, pros = compute_pro(anomaly_maps, ground_truth_maps)
    return compute_aupro(fprs, pros, fpr_limit)


# --- score tables ------------------------------------------------------------


def _cell_number(v) -> float:
    return float("nan") if v is None else float(v)


def _afterpoint_split(s: str) -> int:
    """Where a number's text splits for decimal alignment: at its point,
    else at its exponent, else at its end."""
    if "." in s:
        return s.index(".")
    if "e" in s:
        return s.index("e")
    return len(s)


class ScoreTable:
    """Rows of float scores under named columns (reference
    metrics.py:15-20's DataFrame): ``columns`` maps a column name to its
    values, one per ``index`` label.  None is a missing value."""

    def __init__(self, columns: Dict[str, Sequence[Optional[float]]], index: Sequence[str]):
        self.columns = {k: [_cell_number(v) for v in vals] for k, vals in columns.items()}
        self.index = [str(i) for i in index]
        for k, vals in self.columns.items():
            if len(vals) != len(self.index):
                raise ValueError(f"column {k!r} has {len(vals)} values for {len(self.index)} rows")

    def _rows(self):
        for r, label in enumerate(self.index):
            yield label, [vals[r] for vals in self.columns.values()]

    def to_csv(self) -> str:
        """pandas ``to_csv(float_format="%.4f")``: a missing value is empty."""
        lines = ["," + ",".join(self.columns)]
        for label, vals in self._rows():
            lines.append(",".join([label] + ["" if math.isnan(v) else "%.4f" % v for v in vals]))
        return "\n".join(lines) + "\n"

    def to_latex(self) -> str:
        """pandas ``to_latex(float_format="%.2f")``: booktabs rules, the
        index left-aligned, numbers right-aligned, a missing value NaN."""
        lines = ["\\begin{tabular}{l" + "r" * len(self.columns) + "}", "\\toprule",
                 " & " + " & ".join(self.columns) + " \\\\", "\\midrule"]
        for label, vals in self._rows():
            cells = ["NaN" if math.isnan(v) else "%.2f" % v for v in vals]
            lines.append(" & ".join([label] + cells) + " \\\\")
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines) + "\n"

    def to_markdown(self) -> str:
        """pandas ``to_markdown()`` (tabulate's pipe table): the index
        left-aligned, numbers in ``g`` format aligned on their points and
        right-aligned, every column at least its header plus 2 wide."""
        index_w = max([2] + [len(s) for s in self.index])
        cols = []
        for name, vals in self.columns.items():
            texts = [format(v, "g") for v in vals]
            ints = max(_afterpoint_split(t) for t in texts)
            fracs = max(len(t) - _afterpoint_split(t) for t in texts)
            texts = [t[:_afterpoint_split(t)].rjust(ints) + t[_afterpoint_split(t):].ljust(fracs)
                     for t in texts]
            width = max([len(name) + 2] + [len(t) for t in texts])
            cols.append((name.rjust(width), [t.rjust(width) for t in texts], width))
        lines = ["| " + " | ".join([" " * index_w] + [h for h, _, _ in cols]) + " |",
                 "|:" + "-" * (index_w + 1) + "|"
                 + "|".join("-" * (w + 1) + ":" for _, _, w in cols) + "|"]
        for r, label in enumerate(self.index):
            lines.append("| " + " | ".join([label.ljust(index_w)] + [c[r] for _, c, _ in cols])
                         + " |")
        return "\n".join(lines)


def scores_dataframe(metric_dict: dict, index=None) -> ScoreTable:
    """dict of column → values into a ScoreTable (reference
    metrics.py:15-20)."""
    n = len(next(iter(metric_dict.values()), []))
    return ScoreTable(metric_dict, index if index is not None else [str(i) for i in range(n)])


def export_dataframe(table: ScoreTable, saving_path, name: str, mode: str = "csv") -> str:
    """Write a csv / latex / markdown score table (reference
    metrics.py:23-39) → its path."""
    path = Path(saving_path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / name
    text = {"latex": table.to_latex, "markdown": table.to_markdown}.get(mode, table.to_csv)()
    out.write_text(text)
    return str(out)
