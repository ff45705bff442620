"""The port's patch-mode path as a whole, against the JAX package.

Same weights (f32 model), images and banks on both sides, 64×64 images
(25 windows of 32×32 at stride 8 each):
* the blur ⊗ upsample operator: 1e-7; maps through it: 1e-6;
* ``predict_patches`` embeddings: 1e-3 absolute, and ``score_patch_maps``
  maps: rtol 5e-3 / atol 1e-4, for a bank of ≤ 1024 rows (f32 on both
  sides) and one above (bf16x3 in the port, f32 in JAX on the CPU).  Both
  take bf16 patches and the fused stem; the stem's f32 sums run in
  another order, so a bf16 value may flip by one ulp and carry through;
* ``prepare_pretext_data``: the same split and the same arrays;
* ``export --mode patch`` → ``ServedScorer``: its normality matches JAX's
  patch normality, its maps match JAX's engine with the same bank;
* the HTTP payload and ``cli score --heatmaps`` follow the JAX versions.
"""

import base64
import csv
import io
import json
import urllib.request
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu.evaluation import inference as jinf
from ssad_tpu.ops import image as jim
from ssad_tpu_torch import cli
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops.knn import knn_cosine_scores
from ssad_tpu_torch.ops.patches import extract_patches
from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint, read_artifact
from ssad_tpu_torch.serving.server import AnomalyHTTPServer, BatchingScorer
from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

torch.set_num_threads(1)
IMSIZE = 64
MAP_RTOL, MAP_ATOL, EMB_ATOL = 5e-3, 1e-4, 1e-3


@pytest.mark.parametrize("s", [2, 5, 29])
def test_blur_upsample_operator_matches_jax(s):
    np.testing.assert_allclose(
        im._blur_upsample_matrix(s, 256), jim._blur_upsample_matrix(s, 256), atol=1e-7, rtol=0
    )
    maps = seeded((2, s, s), s)
    np.testing.assert_allclose(
        im.upsample_anomaly_maps(torch.from_numpy(maps), 256).numpy(),
        np.asarray(jim.upsample_anomaly_maps(jnp.asarray(maps), 256)), atol=1e-6, rtol=0,
    )
    if s > 3:  # the staged oracle's reflect padding needs s > 3
        np.testing.assert_allclose(
            im.upsample_anomaly_maps_staged(torch.from_numpy(maps), 256).numpy(),
            im.upsample_anomaly_maps(torch.from_numpy(maps), 256).numpy(), atol=1e-6, rtol=0,
        )


@pytest.fixture(scope="module")
def engines():
    sd = reference_state_dict(seed=7)
    jmodel, params, stats = jax_variables(sd, "float32")
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd, strict=True)
    return sd, jinf.InferenceEngine(jmodel, params, stats), inf.InferenceEngine(model, "cpu")


def test_predict_patches_matches_jax(engines):
    _, jengine, engine = engines
    x = np.array(jim.normalize_imagenet(jnp.asarray(seeded((2, IMSIZE, IMSIZE, 3), 21))))
    jlogits, jemb, jn = jengine.predict_patches(jnp.asarray(x), 32, 8)
    logits, emb, n = engine.predict_patches(torch.from_numpy(x), 32, 8)
    assert n == jn == 25 and emb.shape == (50, 512) and logits.shape == (50, 4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=EMB_ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("bank_rows, upsample_to", [(300, None), (1100, IMSIZE)])
def test_score_patch_maps_matches_jax(engines, bank_rows, upsample_to):
    _, jengine, engine = engines
    rng = np.random.default_rng(bank_rows)
    near = np.asarray(jengine.predict_patches(
        jim.normalize_imagenet(jnp.asarray(seeded((2, IMSIZE, IMSIZE, 3), 22))), 32, 8)[1])
    bank = np.concatenate([near, rng.standard_normal((bank_rows - 50, 512)).astype(np.float32)])
    x = np.array(jim.normalize_imagenet(jnp.asarray(seeded((3, IMSIZE, IMSIZE, 3), 23))))
    ref = np.asarray(jengine.score_patch_maps(
        jnp.asarray(x), jnp.asarray(bank), 32, 8, 3, upsample_to))
    out = engine.score_patch_maps(torch.from_numpy(x), torch.from_numpy(bank), 32, 8, 3,
                                  upsample_to).numpy()
    assert out.shape == ref.shape == ((3, 5, 5) if upsample_to is None else (3, 64, 64))
    np.testing.assert_allclose(out, ref, rtol=MAP_RTOL, atol=MAP_ATOL)


def test_module_stem_route_matches_the_fused_stem(engines):
    """The model's own forward on the 32×32 patches runs the folded stem
    inside the module (f32 for the f32 model, no bf16 rounding of its
    output): the same maps as the engine's fused stem, to the tolerance
    tests/test_stem_pool.py holds the JAX routes to."""
    _, _, engine = engines
    x = torch.from_numpy(seeded((2, IMSIZE, IMSIZE, 3), 27))
    bank = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 512)).astype(np.float32))
    flat = extract_patches(x.to(torch.bfloat16), 32, 8).reshape(-1, 32, 32, 3)
    with torch.inference_mode():
        emb = engine.model(flat)["latent_space"]
    module = knn_cosine_scores(emb, bank, k=3).reshape(2, 5, 5)
    np.testing.assert_allclose(
        module.numpy(), engine.score_patch_maps(x, bank, 32, 8, 3).numpy(),
        rtol=MAP_RTOL, atol=MAP_ATOL,
    )


def test_prepare_pretext_data_matches_jax(fake_mvtec):
    from ssad_tpu.data import mvtec as jmvtec
    from ssad_tpu_torch.data import mvtec

    ref = jmvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    ours = mvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    assert (ours.subject, ours.imsize) == ("bottle", (IMSIZE, IMSIZE))
    np.testing.assert_array_equal(ours.train_images, ref.train_images)
    np.testing.assert_array_equal(ours.val_images, ref.val_images)
    assert mvtec.train_val_split(list("abcdefg"), 0.2, 3) == jmvtec.train_val_split(
        list("abcdefg"), 0.2, 3)


@pytest.fixture(scope="module")
def patch_artifact(engines, fake_mvtec, tmp_path_factory):
    sd = engines[0]
    models = tmp_path_factory.mktemp("patch_models")
    save_reference_checkpoint(models / "bottle" / "best_model.ckpt", sd, None,
                              ModelConfig(compute_dtype="float32"))
    path = export_checkpoint(
        models / "bottle" / "best_model.ckpt", tmp_path_factory.mktemp("patch_art") / "p.ssadpt",
        mode="patch", batch=2, imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu",
        dataset_dir=fake_mvtec,
    )
    return models, path, ServedScorer.from_file(path, device="cpu")


def test_patch_export_matches_jax_engine(engines, fake_mvtec, patch_artifact):
    from ssad_tpu.data import mvtec as jmvtec
    from ssad_tpu.serving.export import _calibration_summary

    _, jengine, engine = engines
    _, path, scorer = patch_artifact
    meta, payload = read_artifact(path)
    assert (meta["mode"], meta["upsample_to"], meta["patch_dim"], meta["stride"]) == (
        "patch", IMSIZE, 32, 8)
    assert meta["knn_impl"] == "cuda"  # 4 train images x 25 windows: 70 rows after the fit
    assert payload["bank"].shape == (70, 512)

    data = jmvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    ref_norm = jinf.normality_embeddings(jengine, None, data, batch_size=4,
                                         patch_localization=True, min_bank_rows=10**9)
    norm = inf.normality_embeddings(engine, None, data.train_images, batch_size=4,
                                    min_bank_rows=10**9, patch_localization=True)
    np.testing.assert_allclose(norm.numpy(), np.asarray(ref_norm), atol=EMB_ATOL, rtol=0)
    bank_rows = {tuple(r) for r in payload["bank"].numpy().round(5).tolist()}
    assert bank_rows <= {tuple(r) for r in norm.numpy().round(5).tolist()}

    # 3 images: a padded second chunk of the batch-2 scorer; JAX takes 4,
    # the shape of its calibration chunks, so one program serves both
    imgs = seeded((4, IMSIZE, IMSIZE, 3), 24)
    (maps,) = scorer(imgs[:3])
    ref = np.asarray(jengine.score_patch_maps(
        jim.normalize_imagenet(jnp.asarray(imgs)), jnp.asarray(payload["bank"].numpy()),
        32, 8, 3, IMSIZE))[:3]
    assert maps.shape == (3, IMSIZE, IMSIZE)
    np.testing.assert_allclose(maps, ref, rtol=MAP_RTOL, atol=MAP_ATOL)

    jcal = _calibration_summary(
        jengine, SimpleNamespace(bank=jnp.asarray(payload["bank"].numpy())), "patch", "knn",
        data, (IMSIZE, IMSIZE), 32, 8, IMSIZE, 3)
    assert meta["calibration"]["source"] == jcal["source"] == "val-image-map-max-knn"
    assert meta["calibration"]["n"] == jcal["n"] == 2
    np.testing.assert_allclose(meta["calibration"]["values"], jcal["values"],
                               rtol=MAP_RTOL, atol=MAP_ATOL)


def test_patch_export_needs_a_dataset(patch_artifact, tmp_path):
    models = patch_artifact[0]
    with pytest.raises(ValueError, match="dataset_dir"):
        export_checkpoint(models / "bottle" / "best_model.ckpt", tmp_path / "x.ssadpt",
                          mode="patch", imsize=(IMSIZE, IMSIZE), device="cpu")


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def test_http_patch_payload_follows_jax(patch_artifact):
    from PIL import Image

    from ssad_tpu.serving.server import build_score_payload as jax_payload

    _, _, scorer = patch_artifact
    img = seeded((IMSIZE, IMSIZE, 3), 25)
    body = io.BytesIO()
    np.save(body, img)
    (amap,) = scorer(img[None])
    srv = AnomalyHTTPServer(BatchingScorer(scorer, batch=scorer.batch), scorer.meta, port=0).start()
    try:
        plain = _post(srv.port, "/score", body.getvalue())
        heat = _post(srv.port, "/score?heatmap=1", body.getvalue())
    finally:
        srv.stop()
    ref, observed = jax_payload((amap[0],), scorer.meta, True, 0.0)
    assert set(plain) == {"map_max", "map_mean", "ms"}
    assert plain["map_max"] == heat["map_max"] == ref["map_max"] == observed
    assert plain["map_mean"] == ref["map_mean"]
    png = Image.open(io.BytesIO(base64.b64decode(heat["heatmap_b64"])))
    assert png.size == (IMSIZE, IMSIZE) and heat["heatmap_b64"] == ref["heatmap_b64"]


def test_cli_score_heatmaps(patch_artifact, tmp_path, capsys):
    from PIL import Image

    from ssad_tpu.serving.server import heatmap_to_uint8

    _, path, scorer = patch_artifact
    imgs = seeded((3, IMSIZE, IMSIZE, 3), 26)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, x in enumerate(imgs):
        np.save(folder / f"{i}.npy", x)
    out = tmp_path / "scored"
    assert cli.main(["score", "--artifact", str(path), str(folder), "--out", str(out),
                     "--heatmaps", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mode"] == "patch" and summary["n"] == 3 and "n_anomalous" not in summary
    with open(out / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    (maps,) = scorer(imgs)
    assert list(rows[0]) == ["path", "map_max", "map_mean"]
    np.testing.assert_array_equal([float(r["map_max"]) for r in rows], maps.max(axis=(1, 2)))
    pngs = sorted((out / "heatmaps").iterdir())
    assert [p.name for p in pngs] == ["00000_0.png", "00001_1.png", "00002_2.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(pngs[1])), heatmap_to_uint8(maps[1]))
    # an image artifact refuses --heatmaps
    rows = np.random.default_rng(3).standard_normal((20, 512)).astype(np.float32)
    image_art = export_checkpoint(patch_artifact[0] / "bottle" / "best_model.ckpt",
                                  tmp_path / "img.ssadpt", imsize=(IMSIZE, IMSIZE),
                                  device="cpu", normality=rows)
    with pytest.raises(SystemExit, match="patch"):
        cli.main(["score", "--artifact", image_art, str(folder), "--out", str(out),
                  "--heatmaps", "--device", "cpu"])


def test_cli_export_patch_mode(patch_artifact, fake_mvtec, tmp_path, capsys):
    models, path, _ = patch_artifact
    art = tmp_path / "cli_patch.ssadpt"
    assert cli.main(["export", "--models-dir", str(models), "--subject", "bottle",
                     "--mode", "patch", "--dataset-dir", str(fake_mvtec), "--imsize", str(IMSIZE),
                     "--batch", "2", "--n-normality-images", "3", "--out", str(art),
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mode"] == "patch"
    meta, payload = read_artifact(art)
    # 3 of the 4 train images x 25 windows = 75 rows, 53 after the 70/30 fit
    assert meta["mode"] == "patch" and payload["bank"].shape == (53, 512)
