"""The evaluation slice on the card: the fused pixel metrics on CUDA
tensors against the host oracles, and ``evaluate_category`` at both
levels with the kernels' launch counts.  Every test takes the
``cuda_device`` fixture and skips where there is no card.

This file imports neither JAX nor the JAX package, so it runs on a
machine without them:
    python -m pytest --noconftest tests/test_torch_eval_cuda.py
Bounds against the f64 oracles: 2e-4 on AUROC, F1 and IoU, 3e-4 on AUPRO
(the f32 program's, as on the CPU: tests/test_torch_metrics_device.py).
The category runs use a seeded 256² bottle tree (chip_smoke.py's writers:
6 train-good images, 9 test images) and a seeded bf16 PeraNet: at image
level csrc/knn.cu fits and scores; in patch mode 3 normality images give
2,523 windows and a 1,766-row bank, so csrc/stem_pool.cu embeds every
batch and csrc/knn_tiled.cu fits and scores.
"""

import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.evaluation import metrics as M
from ssad_tpu_torch.evaluation import metrics_device as MD


def _problem(seed=0, n=6, size=96):
    rng = np.random.default_rng(seed)
    gts = np.zeros((n, size, size), np.uint8)
    yy, xx = np.ogrid[:size, :size]
    for i in range(n - 1):
        cy, cx, r = rng.integers(10, size - 10, 2).tolist() + [int(rng.integers(3, 9))]
        gts[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    maps = (0.8 * gts + rng.normal(0.3, 0.25, gts.shape)).astype(np.float32)
    return maps, gts


@pytest.mark.parametrize("quantize", [None, 8])
def test_device_metrics_on_the_card_match_the_oracles(cuda_device, quantize):
    maps, gts = _problem()
    if quantize:
        maps = np.round(maps * quantize) / quantize
    got = MD.pixel_metrics(torch.from_numpy(maps).to(cuda_device), gts)
    labels, scores = gts.ravel() > 0, maps.ravel().astype(np.float64)
    fpr, tpr, _ = M.roc_curve(labels, scores)
    thr = M.optimal_f1_threshold(labels, scores)
    fprs, pros = M.compute_pro(maps, gts)
    assert abs(got.auroc - M.auc(fpr, tpr)) <= 2e-4
    assert abs(got.f1 - M.f1_score(labels, scores, thr)) <= 2e-4
    assert abs(got.iou - M.iou_score(gts.ravel(), scores, thr)) <= 2e-4
    assert abs(got.aupro - M.compute_aupro(fprs, pros, 0.3)) <= 3e-4
    assert got.roc[0][0] == 0.0 and got.roc[0][-1] == 1.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import chip_smoke as cs

    root = tmp_path_factory.mktemp("eval_tree")
    cs.write_synth_tree(root, images=6)
    cs.write_eval_split(root / "bottle", split=(("good", 3), ("broken_large", 2),
                                                ("broken_small", 2), ("contamination", 2)))
    return root


@pytest.mark.parametrize("patch", [False, True])
def test_evaluate_category_on_the_card_launches_the_kernels(cuda_device, tree, patch):
    from ssad_tpu_torch.config import EvalConfig, ModelConfig
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import evaluator as ev
    from ssad_tpu_torch.evaluation.inference import InferenceEngine
    from ssad_tpu_torch.models.peranet import build_model, init_model
    from ssad_tpu_torch.ops import knn, stem_pool

    model = init_model(build_model(ModelConfig()), torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, cuda_device)
    cfg = EvalConfig(imsize=(256, 256), batch_size=8, patch_localization=patch)
    data = mvtec.prepare_pretext_data(tree, "bottle", imsize=cfg.imsize)
    test = mvtec.prepare_mvtec_test_data(tree, "bottle", imsize=cfg.imsize)
    knn.knn_cosine_scores_cuda.launches = 0
    knn.knn_cosine_scores_tiled_cuda.launches = 0
    stem_pool.stem_pool_cuda.launches = 0
    r = ev.evaluate_category(engine, None, data, test, cfg, "bottle", with_artificial=False)
    if patch:
        assert stem_pool.stem_pool_cuda.launches > 0
        assert knn.knn_cosine_scores_tiled_cuda.launches > 0
        values = (r.pixel_auroc, r.iou, r.aupro)
    else:
        assert knn.knn_cosine_scores_cuda.launches > 0
        values = (r.image_auroc, r.image_f1, r.gradcam_pixel_auroc, r.gradcam_aupro)
    assert all(v is not None and 0.0 <= v <= 1.0 for v in values), values
