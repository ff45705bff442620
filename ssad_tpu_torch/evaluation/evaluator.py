"""Category evaluation and the category sweep with its score tables.

Counterpart of ssad_tpu/evaluation/evaluator.py (reference
src/evaluator.py:128-698 and tools.py:28-146):

* image level: MVTec test predictions, k-NN (or Mahalanobis) scores from
  the memory bank (or train-set embeddings), image AUROC and optimal F1; the pretext
  classification report on synthetic batches; Grad-CAM maps of every
  test image scored at pixel level, and overlays of the predicted
  defects;
* patch level: sliding-window embeddings → k-NN (or Mahalanobis) scores
  → blur ⊗ upsample maps → pixel AUROC, IoU and AUPRO;
* the sweep: a row per category and their average, textures and objects
  tables, written as csv, LaTeX and Markdown, and the overlaid curves.

On a CUDA engine every forward, k-NN score (``ops/knn.py``: csrc/knn.cu,
or csrc/knn_tiled.cu above 1024 bank rows), stem (csrc/stem_pool.cu on
32×32 windows), Grad-CAM and the pixel metrics (``metrics_device``) run
on the card; only scalars, curves and the figures' inputs come back.

The files are the JAX evaluator's; ``<subject>_tsne.png`` is drawn from
the port's own t-SNE (evaluation/tsne.py), run on the embeddings' device,
where the JAX package calls scikit-learn's.  As in the JAX package, the patch
branch scores every test image, and patch normality comes from
``n_normality_images`` train images.  The 70/30 fit split is permuted by a
CPU ``torch.Generator`` seeded with ``cfg.seed`` (the JAX package uses
``jax.random``), unless ``perm`` is given.  ``cfg.coreset`` distils the
k-NN bank after that split; the Mahalanobis scorer ignores it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import AugConfig, EvalConfig
from ssad_tpu_torch.constants import EvaluationScores, ModelOutputs
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.data.synthetic import SynthSpec
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.evaluation import metrics as M
from ssad_tpu_torch.evaluation import metrics_device as MD
from ssad_tpu_torch.evaluation import visualization as vis
from ssad_tpu_torch.models.detector import make_detector
from ssad_tpu_torch.models.gradcam import make_gradcam_fn
from ssad_tpu_torch.ops import image as im


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# --- library-level metric dispatch (reference tools.Evaluator) --------------


class Evaluator:
    """Metric dispatch over a ModelOutputs container (reference
    tools.py:28-137): f1-score is image-level only, aupro and iou are
    patch-level only.  Host oracles."""

    def __init__(self, evaluation_metrics: Sequence[str] = ()):
        unknown = set(evaluation_metrics) - set(constants.METRICS)
        if unknown:
            raise ValueError(
                f"unknown metrics {sorted(unknown)}; valid: {list(constants.METRICS)}")
        self.evaluation_metrics = tuple(evaluation_metrics)
        self.scores = EvaluationScores()

    def evaluate(self, outputs: ModelOutputs, subject: str, outputs_dir: Optional[str] = None,
                 patch_level: bool = False, aupro_fpr_limit: float = 0.3) -> EvaluationScores:
        labels = _host(outputs.ground_truths if patch_level else outputs.y_true_binary).ravel()
        scores = _host(outputs.anomaly_maps).ravel()
        threshold = M.optimal_f1_threshold(labels > 0, scores)
        if "auroc" in self.evaluation_metrics:
            fpr, tpr, _ = M.roc_curve(labels > 0, scores)
            self.scores.auroc = M.auc(fpr, tpr)
            if outputs_dir:
                name = f"{subject}_{'pixel' if patch_level else 'image'}_roc.png"
                vis.plot_curve(fpr, tpr, self.scores.auroc, outputs_dir,
                               f"Roc curve for {subject.upper()}", name)
        if "f1-score" in self.evaluation_metrics:
            if patch_level:
                raise ValueError("'f1-score' is not valid in patch-level mode")
            self.scores.f1_score = M.f1_score(labels > 0, scores, threshold)
        if "aupro" in self.evaluation_metrics:
            if not patch_level:
                raise ValueError("'aupro' is not valid in image-level mode")
            maps = _host(outputs.anomaly_maps)
            maps = maps[:, 0] if maps.ndim == 4 else maps
            fprs, pros = M.compute_pro(maps, _host(outputs.ground_truths))
            self.scores.aupro = M.compute_aupro(fprs, pros, aupro_fpr_limit)
            if outputs_dir:
                vis.plot_curve(fprs, pros, self.scores.aupro, outputs_dir,
                               f"Pro curve for {subject.upper()}", f"{subject}_pro.png")
        if "iou" in self.evaluation_metrics:
            if not patch_level:
                raise ValueError("'iou' is not valid in image-level mode")
            self.scores.iou = M.iou_score(labels, scores, threshold)
        return self.scores


# --- artificial (pretext) evaluation ----------------------------------------


PRETEXT_CLASS_NAMES = ("good", "polygon patch", "scar", "line")


@dataclasses.dataclass
class ArtificialScores:
    accuracy: float
    f1_macro: float
    auroc_binary: float
    #: per-class rows {name: (precision, recall, f1, support)}
    per_class: Optional[Dict[str, Tuple[float, float, float, int]]] = None

    def classification_report(self) -> str:
        """Plain-text per-class report (precision, recall, f1, support),
        the shape of the reference's printed sklearn report."""
        lines = [f"{'':>14} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
        for name, (p, r, f1, n) in (self.per_class or {}).items():
            lines.append(f"{name:>14} {p:9.4f} {r:9.4f} {f1:9.4f} {n:9d}")
        lines.append("")
        lines.append(f"{'accuracy':>14} {'':>9} {'':>9} {self.accuracy:9.4f}")
        lines.append(f"{'macro f1':>14} {'':>9} {'':>9} {self.f1_macro:9.4f}")
        lines.append(f"{'binary auroc':>14} {'':>9} {'':>9} {self.auroc_binary:9.4f}")
        return "\n".join(lines)


def evaluate_artificial(outputs: ModelOutputs) -> ArtificialScores:
    """4-way pretext classification quality (reference ArtificialEvaluator,
    evaluator.py:31-126): per-class precision/recall/F1/support, accuracy,
    macro F1 over the classes present or predicted (sklearn's), and the
    good-vs-defect AUROC of 1 − p(good)."""
    y = _host(outputs.y_true_multiclass)
    logits = _host(outputs.raw_predictions).astype(np.float64)
    y_hat = np.argmax(logits, axis=1)
    accuracy = float((y_hat == y).mean())
    per_class: Dict[str, Tuple[float, float, float, int]] = {}
    f1s = []
    for c in range(logits.shape[1]):
        tp = float(((y_hat == c) & (y == c)).sum())
        fp = float(((y_hat == c) & (y != c)).sum())
        fn = float(((y_hat != c) & (y == c)).sum())
        support = int((y == c).sum())
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        name = PRETEXT_CLASS_NAMES[c] if c < len(PRETEXT_CLASS_NAMES) else str(c)
        per_class[name] = (prec, rec, f1, support)
        if support or tp + fp > 0:
            f1s.append(f1)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    auroc_bin = M.auroc(y > 0, 1.0 - probs[:, 0])
    return ArtificialScores(accuracy, float(np.mean(f1s)), auroc_bin, per_class)


def _render_eval_gradcams(outputs: ModelOutputs, outputs_dir: str, subject: str,
                          cam_maps: torch.Tensor, max_images: int = 8) -> List[str]:
    """Grad-CAM overlays of the test images the classifier calls defective
    (reference evaluator.py:271-284), from the maps already computed for
    every test image."""
    y_hat = _host(outputs.y_hat)
    paths = []
    for i in np.where(y_hat > 0)[0][:max_images]:
        overlay = vis.heatmap_overlay(_host(outputs.original_data[i]), _host(cam_maps[i]))
        paths.append(vis.save_image(
            overlay, Path(outputs_dir) / "gradcam" / f"{subject}_{i}_gradcam.png"))
    return paths


# --- per-category evaluation -------------------------------------------------


def _use_device_metrics(cfg: EvalConfig, maps: torch.Tensor, gts: np.ndarray) -> bool:
    """The fused program (metrics_device.py) when enabled — by default
    when the maps are on a CUDA device — and both pixel classes occur (the
    host oracles keep their degenerate-input behaviour)."""
    use = cfg.device_metrics
    if use is None:
        use = maps.device.type == "cuda"
    pos = gts > 0
    return bool(use) and bool(pos.any()) and not bool(pos.all())


@dataclasses.dataclass
class CategoryResult:
    subject: str
    image_auroc: Optional[float] = None
    image_f1: Optional[float] = None
    pixel_auroc: Optional[float] = None
    iou: Optional[float] = None
    aupro: Optional[float] = None
    artificial: Optional[ArtificialScores] = None
    image_roc: Optional[Tuple[np.ndarray, np.ndarray]] = None
    pixel_roc: Optional[Tuple[np.ndarray, np.ndarray]] = None
    pro_curve: Optional[Tuple[np.ndarray, np.ndarray]] = None
    #: image mode: pixel metrics of the Grad-CAM maps
    gradcam_pixel_auroc: Optional[float] = None
    gradcam_aupro: Optional[float] = None


def _pixel_scores(cfg: EvalConfig, maps: torch.Tensor, gts: np.ndarray):
    """(pixel AUROC, (fpr, tpr), IoU, AUPRO, (fprs, pros)) of (N, H, W)
    maps against the masks: the fused program on the maps' device, or the
    host oracles."""
    if _use_device_metrics(cfg, maps, gts):
        pm = MD.pixel_metrics(maps, gts, fpr_limit=cfg.aupro_fpr_limit)
        return pm.auroc, pm.roc, pm.iou, pm.aupro, pm.pro
    labels = gts.ravel()
    scores = np.nan_to_num(_host(maps).ravel())
    fpr, tpr, _ = M.roc_curve(labels > 0, scores)
    thr = M.optimal_f1_threshold(labels > 0, scores)
    fprs, pros = M.compute_pro(_host(maps), gts)
    return (M.auc(fpr, tpr), (fpr, tpr), M.iou_score(labels, scores, thr),
            M.compute_aupro(fprs, pros, cfg.aupro_fpr_limit), (fprs, pros))


def evaluate_category(engine: inf.InferenceEngine, bank, data: mvtec.PretextData,
                      test_data: mvtec.MVTecTestData, cfg: EvalConfig, subject: str,
                      outputs_dir: Optional[str] = None, with_artificial: bool = True,
                      n_normality_images: Optional[int] = None,
                      perm: Optional[torch.Tensor] = None) -> CategoryResult:
    """One category, image or patch level by ``cfg.patch_localization``.
    ``bank``: the checkpoint's memory bank or None; ``perm``: the fit
    split's permutation (default: drawn from ``cfg.seed``)."""
    result = CategoryResult(subject=subject)
    if n_normality_images is None:
        n_normality_images = cfg.n_normality_images
    gts = np.asarray(test_data.ground_truths)

    if not cfg.patch_localization:
        # --- image level (evaluator.py:243-281, :334-352) ---
        outputs = inf.predict_mvtec(engine, test_data, batch_size=cfg.batch_size)
        normality = inf.normality_embeddings(engine, bank, data.train_images,
                                             batch_size=cfg.batch_size)
        outputs, _ = inf.attach_anomaly_scores(outputs, normality, k=cfg.knn_k, seed=cfg.seed,
                                               perm=perm, scorer=cfg.scorer,
                                               coreset=cfg.coreset)
        labels, scores = _host(outputs.y_true_binary), _host(outputs.anomaly_maps)
        fpr, tpr, _ = M.roc_curve(labels > 0, scores)
        result.image_auroc = M.auc(fpr, tpr)
        result.image_roc = (fpr, tpr)
        thr = M.optimal_f1_threshold(labels > 0, scores)
        result.image_f1 = M.f1_score(labels > 0, scores, thr)

        if with_artificial:
            spec = SynthSpec(subject=subject, imsize=cfg.imsize, aug=AugConfig())
            art = inf.predict_artificial(engine, data, spec, num_samples=256,
                                         batch_size=cfg.batch_size, seed=cfg.seed)
            result.artificial = evaluate_artificial(art)
            if outputs_dir:
                from ssad_tpu_torch.evaluation.error_analysis import ErrorAnalyzer

                Path(outputs_dir).mkdir(parents=True, exist_ok=True)
                (Path(outputs_dir) / f"{subject}_artificial_report.txt").write_text(
                    result.artificial.classification_report() + "\n")
                ErrorAnalyzer(art).analyze(
                    output_path=str(Path(outputs_dir) / f"{subject}_errors.png"), seed=cfg.seed)
                vis.plot_tsne(
                    torch.cat([torch.as_tensor(art.embeddings),
                               torch.as_tensor(outputs.embeddings)]),
                    np.concatenate([_host(art.y_true_multiclass),
                                    _host(outputs.y_true_multiclass)]),
                    outputs_dir, f"{subject.upper()} feature visualization",
                    f"{subject}_tsne.png")

        # Grad-CAM maps of every test image (zero where the classifier says
        # 'good'), scored at pixel level (evaluator.py:262-284)
        gradcam = make_gradcam_fn(engine.model)
        bs = max(1, min(8, cfg.batch_size))
        n_test = outputs.tensor_data.shape[0]
        cam_maps = torch.cat([gradcam(outputs.tensor_data[lo:lo + bs], outputs.y_hat[lo:lo + bs])
                              for lo in range(0, n_test, bs)])
        has_both = (gts > 0).any() and not (gts > 0).all()
        if has_both:
            auroc_px, (fpr_px, tpr_px), _, aupro_px, (fprs_pro, pros) = _pixel_scores(
                cfg, cam_maps, gts)
            result.gradcam_pixel_auroc, result.gradcam_aupro = auroc_px, aupro_px

        if outputs_dir:
            vis.plot_curve(fpr, tpr, result.image_auroc, outputs_dir,
                           f"Roc curve for {subject.upper()}", f"{subject}_image_roc.png")
            if result.gradcam_pixel_auroc is not None:
                vis.plot_curve(fpr_px, tpr_px, result.gradcam_pixel_auroc, outputs_dir,
                               f"Roc curve for {subject.upper()}", f"{subject}_pixel_roc.png")
                vis.plot_curve(fprs_pro, pros, result.gradcam_aupro, outputs_dir,
                               f"Pro curve for {subject.upper()}", f"{subject}_pro.png")
            _render_eval_gradcams(outputs, outputs_dir, subject, cam_maps)
    else:
        # --- patch level (evaluator.py:286-374) ---
        normality = inf.normality_embeddings(
            engine, None, data.train_images, batch_size=4, patch_localization=True,
            patch_dim=cfg.patch_dim, stride=cfg.stride,
            min_bank_rows=10**9,  # patch mode always re-embeds (evaluator.py:297-300)
            max_images=n_normality_images, seed=cfg.seed)
        # a k-NN coreset is selected inside fit, after the 70/30 split;
        # Mahalanobis ignores it (the Gaussian's moments are fixed size)
        det = make_detector(cfg.scorer, k=cfg.knn_k).fit(
            normality, torch.Generator().manual_seed(cfg.seed), perm=perm, coreset=cfg.coreset)
        bs = max(1, min(8, cfg.batch_size))
        maps_list = []
        for lo in range(0, test_data.images.shape[0], bs):
            raw = torch.from_numpy(np.ascontiguousarray(test_data.images[lo:lo + bs]))
            maps_list.append(engine.score_maps(
                im.normalize_imagenet(raw.to(engine.device)), det.score, dim=cfg.patch_dim,
                stride=cfg.stride, upsample_to=cfg.upsample_size))
        (result.pixel_auroc, result.pixel_roc, result.iou, result.aupro,
         result.pro_curve) = _pixel_scores(cfg, torch.cat(maps_list), gts)
        if outputs_dir:
            vis.plot_curve(*result.pixel_roc, result.pixel_auroc, outputs_dir,
                           f"Roc curve for {subject.upper()}", f"{subject}_pixel_roc.png")
            vis.plot_curve(*result.pro_curve, result.aupro, outputs_dir,
                           f"Pro curve for {subject.upper()}", f"{subject}_pro.png")
    return result


# --- the sweep -----------------------------------------------------------------


def _rows_with_average(rows: Dict[str, List[float]], index: List[str]) -> M.ScoreTable:
    avg = {k: float(np.mean(v)) for k, v in rows.items()}
    return M.scores_dataframe({k: list(v) + [avg[k]] for k, v in rows.items()},
                              index=index + ["average"])


def export_score_tables(table: M.ScoreTable, tables_dir: str, stem: str) -> None:
    for mode, sub, ext in (("csv", "csv", "csv"), ("latex", "latex", "tex"),
                           ("markdown", "markdown", "md")):
        M.export_dataframe(table, Path(tables_dir) / sub, f"{stem}.{ext}", mode)


def evaluate_categories(dataset_dir: str, models_dir: str, subjects: Sequence[str],
                        cfg: EvalConfig, outputs_dir: str, checkpoint_name: str = "best_model",
                        device=None) -> Dict[str, CategoryResult]:
    """Evaluate the subjects one after another from
    ``<models_dir>/<subject>/<checkpoint_name>.ckpt``, with per-category
    plots under ``<outputs_dir>/<subject>`` and the aggregate tables and
    curve overlays under ``<outputs_dir>/tables`` (reference evaluate(),
    evaluator.py:432-564)."""
    results: Dict[str, CategoryResult] = {}
    for subject in subjects:
        engine, bank, _ = inf.load_engine(Path(models_dir) / subject / f"{checkpoint_name}.ckpt",
                                          device)
        data = mvtec.prepare_pretext_data(dataset_dir, subject, imsize=cfg.imsize, seed=cfg.seed)
        test_data = mvtec.prepare_mvtec_test_data(dataset_dir, subject, imsize=cfg.imsize)
        results[subject] = evaluate_category(engine, bank, data, test_data, cfg, subject,
                                             outputs_dir=str(Path(outputs_dir) / subject))

    tables_dir = str(Path(outputs_dir) / "tables")
    subjects = list(subjects)
    if cfg.patch_localization:
        rows = {"AUC (pixel)": [results[s].pixel_auroc for s in subjects],
                "IOU": [results[s].iou for s in subjects],
                "AUPRO": [results[s].aupro for s in subjects]}
        stem = "patch"
    else:
        rows = {"AUC (image)": [results[s].image_auroc for s in subjects],
                "F1 (image)": [results[s].image_f1 for s in subjects]}
        stem = "image"
    export_score_tables(_rows_with_average(rows, subjects), tables_dir, f"{stem}_all_scores")

    if not cfg.patch_localization and any(results[s].artificial for s in subjects):
        art = [results[s].artificial for s in subjects]
        art_rows = {"accuracy": [getattr(a, "accuracy", float("nan")) for a in art],
                    "f1": [getattr(a, "f1_macro", float("nan")) for a in art],
                    "auroc": [getattr(a, "auroc_binary", float("nan")) for a in art]}
        export_score_tables(_rows_with_average(art_rows, subjects), tables_dir,
                            "artificial_all_scores")

    for group_name, group in (("textures", [s for s in subjects if constants.is_texture(s)]),
                              ("objects", [s for s in subjects if not constants.is_texture(s)])):
        if not group:
            continue
        sub_rows = {k: [v[subjects.index(s)] for s in group] for k, v in rows.items()}
        export_score_tables(_rows_with_average(sub_rows, group), tables_dir,
                            f"{stem}_{group_name}_scores")
        if cfg.patch_localization:
            curves = [(s,) + tuple(results[s].pixel_roc) + (results[s].pixel_auroc,)
                      for s in group if results[s].pixel_roc]
            if curves:
                vis.plot_multiple_curves(curves, tables_dir, f"{group_name} pixel ROC",
                                         f"{group_name}_pixel_rocs.png")
            pro = [(s,) + tuple(results[s].pro_curve) + (results[s].aupro,)
                   for s in group if results[s].pro_curve]
            if pro:
                vis.plot_multiple_curves(pro, tables_dir, f"{group_name} PRO",
                                         f"{group_name}_pros.png")
        else:
            curves = [(s,) + tuple(results[s].image_roc) + (results[s].image_auroc,)
                      for s in group if results[s].image_roc]
            if curves:
                vis.plot_multiple_curves(curves, tables_dir, f"{group_name} image ROC",
                                         f"{group_name}_rocs.png")
    return results
