"""The port's transformer trunk (models/vit.py, DINOv2 with registers) on the
CPU at tiny widths, against the plain reference ``port_bench/reference/vit.py``
(f32, TF32 off, importing nothing of the port).

Held:
* the trunk and the whole PeraNet in float32 equal the reference within
  1e-5 of the largest reference value (the same f32 operations in another
  order: the attention's fused softmax, the convolution's sum order), at
  an uninterpolated grid (70², the table's own 5 × 5) and an interpolated,
  non-square one (84 × 98 → 6 × 7), with registers and SwiGLU that move
  the result;
* in bfloat16 within 5e-2 of the largest reference value: bf16 keeps 8
  significant bits (each rounding up to 2⁻⁹ relative), and the path rounds
  about ten times in series (the projection, each block's LayerNorm
  output, qkv, q k v, the attention's output, proj, w12, silu·b, w3), each
  product summing rounded operands of both signs;
* the published preset's keys and shapes are the reference's
  ``state_shapes`` (1,136,486,912 trunk parameters), built on the ``meta``
  device without allocating;
* export (image mode) → ``ServedScorer`` → ``BatchingScorer`` scores as the
  reference's scoring does; under ``torch.profiler`` each image forward
  holds one ``ssad.vit.embed``, ``.blocks`` and ``.taps``, in that order;
* patch mode, Grad-CAM and training refuse the trunk, naming it; a side
  that is not a multiple of 14 is refused;
* the int8 weight path quantizes the trunk's matrices and the patch
  projection and keeps the token tables and vectors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from port_bench.core import seeded
from port_bench.reference import scoring as ref
from port_bench.reference import vit as ref_vit
from port_bench.reference.peranet import normalize
from ssad_tpu_torch.config import ModelConfig, TrainConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine, normality_embeddings
from ssad_tpu_torch.models import peranet, vit
from ssad_tpu_torch.models.gradcam import compute_gradcam
from ssad_tpu_torch.models.peranet import build_model, init_model

TINY = "vit_tiny"
TINY_ARCH = dict(embed_dim=32, depth=4, num_heads=4, hidden=88, patch=14, grid=5, registers=4)
CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_TOL = 5e-2


@pytest.fixture()
def tiny(monkeypatch):
    """The tiny trunk under one name in the port's and the reference's tables."""
    monkeypatch.setitem(ref_vit.ARCHS, TINY, TINY_ARCH)
    monkeypatch.setitem(vit.BACKBONES, TINY, lambda dtype: vit.VisionTransformer(
        embed_dim=32, depth=4, num_heads=4, patch_size=14, img_size=70,
        num_register_tokens=4, dtype=dtype))


def tiny_state(seed=2**31 + 3):
    """The benchmark's seeded draw at the tiny widths, with LayerScale, the
    registers and the position table raised so that each moves the result."""
    sd = seeded.fill_state(ref_vit.state_shapes(TINY), seed, CPU)
    gen = torch.Generator().manual_seed(seed)
    for k in sd:
        if k.endswith(".gamma"):
            sd[k] = 1.0 + 0.2 * torch.randn(sd[k].shape, generator=gen)
        elif k.endswith(("register_tokens", "pos_embed")):
            sd[k] = sd[k] * 20.0
    return sd


def port_model(sd, dtype="float32"):
    m = build_model(ModelConfig(backbone=TINY, compute_dtype=dtype))
    m.load_state_dict(sd, strict=True)
    return m.eval()


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def images(n, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3))
                            .astype(np.float32))


@pytest.mark.parametrize("hw", [(70, 70), (84, 98)], ids=["table_grid", "resampled"])
def test_f32_trunk_and_peranet_equal_the_reference(tiny, hw):
    sd = tiny_state()
    model, net = port_model(sd), ref_vit.ViTPeraNetReference(sd, TINY, block=2)
    x = normalize(images(3, *hw, seed=1))
    with torch.inference_mode():
        pooled, feats = model.feature_extractor(x.permute(0, 3, 1, 2))
        out = model(x)
    r_pooled, r_feats = net.trunk(x.permute(0, 3, 1, 2))
    assert rel(pooled, r_pooled) < F32_TOL
    for tap in vit.TAPS:
        assert feats[tap].shape == (3, 32, hw[0] // 14, hw[1] // 14)
        assert rel(feats[tap], r_feats[tap]) < F32_TOL
    logits, emb = net.forward(x)
    assert rel(out["classifier"], logits) < F32_TOL
    assert rel(out["latent_space"], emb) < F32_TOL


def test_registers_and_swiglu_move_the_result(tiny):
    """The comparison above is sensitive to both: without them the port's
    taps move by far more than its tolerance."""
    sd = tiny_state()
    x = normalize(images(2, 84, 98, seed=2)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        base = port_model(sd).feature_extractor(x)[1]["layer3"]
        no_reg = dict(sd, **{"feature_extractor.register_tokens":
                             torch.zeros_like(sd["feature_extractor.register_tokens"])})
        no_mlp = dict(sd, **{k: torch.zeros_like(v) for k, v in sd.items() if ".ls2." in k})
        for changed in (no_reg, no_mlp):
            assert rel(port_model(changed).feature_extractor(x)[1]["layer3"], base) > 1e-2


def test_bf16_within_its_tolerance(tiny):
    sd = tiny_state()
    net = ref_vit.ViTPeraNetReference(sd, TINY)
    x = normalize(images(4, 84, 98, seed=3))
    with torch.inference_mode():
        out = port_model(sd, "bfloat16")(x)
    logits, emb = net.forward(x)
    gaps = rel(out["classifier"], logits), rel(out["latent_space"], emb)
    assert max(gaps) < BF16_TOL
    assert max(gaps) > F32_TOL  # it did run in bf16


def test_published_preset_shapes_on_meta():
    shapes = ref_vit.state_shapes("dinov2_vitg14_reg")
    trunk = sum(torch.Size(s).numel() for k, s in shapes.items()
                if k.startswith("feature_extractor."))
    assert trunk == 1_136_486_912
    with torch.device("meta"):
        model = build_model(ModelConfig(backbone="dinov2_vitg14_reg"))
    sd = model.state_dict()
    assert list(sd) == list(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in sd.items())
    assert all(v.is_meta for v in sd.values())
    fe = model.feature_extractor
    assert fe.stage_channels == {t: 1536 for t in vit.TAPS} and fe.tap_blocks == (10, 20, 30, 40)
    assert vit.swiglu_hidden(1536, 4.0) == 4096


def test_init_model_draws_the_tables(tiny):
    model = init_model(build_model(ModelConfig(backbone=TINY)), torch.Generator().manual_seed(0))
    fe = model.feature_extractor.requires_grad_(False)
    assert 0 < float(fe.cls_token.abs().max()) < 1e-4
    assert 0 < float(fe.register_tokens.abs().max()) < 1e-4
    assert 0.01 < float(fe.pos_embed.std()) < 0.03
    assert float(fe.mask_token.abs().max()) == 0.0
    assert all(float(b.ls1.gamma.min()) == 1.0 == float(b.ls2.gamma.max()) for b in fe.blocks)
    assert float(fe.blocks[0].attn.qkv.bias.abs().max()) == 0.0


def _tiny_artifact(tmp_path, sd, normality, seed, batch=4, size=84):
    from ssad_tpu_torch.serving.export import export_checkpoint
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    cfg = ModelConfig(backbone=TINY, compute_dtype="float32")
    ckpt = save_reference_checkpoint(tmp_path / "best_model.ckpt", sd,
                                     train_config=dataclasses.replace(TrainConfig(), model=cfg))
    return ckpt, export_checkpoint(ckpt, tmp_path / "vit.ssadpt", mode="image", batch=batch,
                                   imsize=(size, size), normality=normality, seed=seed,
                                   device="cpu")


def test_served_image_mode_scores_as_the_reference(tiny, tmp_path):
    """export (image mode, normality embedded by the engine) → ServedScorer →
    BatchingScorer against the reference's embedding, 70/30 fit and k-NN
    scores, all in f32."""
    from ssad_tpu_torch.serving.export import load_scorer
    from ssad_tpu_torch.serving.server import BatchingScorer

    sd, seed, k = tiny_state(), 7, 3
    normal = seeded.images(24, 84, 5, "normality", CPU)
    engine = InferenceEngine(port_model(sd), CPU)
    normality = normality_embeddings(engine, None, normal.numpy(), batch_size=8,
                                     min_bank_rows=10**9)
    _, art = _tiny_artifact(tmp_path, sd, normality, seed)
    scorer = load_scorer(art, "cpu")
    requests = seeded.images(6, 84, 5, "requests", CPU)
    batcher = BatchingScorer(scorer, batch=4, max_delay_ms=2.0)
    try:
        rows = [batcher.score(img.numpy()) for img in requests]
        stats = batcher.stats()
    finally:
        batcher.close()
    scores = torch.tensor([float(r[0]) for r in rows])
    logits = torch.from_numpy(np.stack([r[2] for r in rows]))

    net = ref_vit.ViTPeraNetReference(sd, TINY)
    bank, threshold = ref.fit(ref.embed(net, normal), k, seed)
    r_logits, r_emb = net.forward(normalize(requests))
    r_scores = ref.knn_scores(r_emb, bank, k)
    assert abs(scorer.threshold - threshold) < F32_TOL * threshold
    assert float((scores - r_scores).abs().max()) < F32_TOL * threshold
    assert rel(logits, r_logits) < F32_TOL
    assert stats["requests"] == 6


def test_trunk_spans_nest_in_the_image_forward(tiny):
    """Each served image forward holds one ``ssad.vit.embed``, ``.blocks``
    and ``.taps``, in that order, inside its ``ssad.image.forward``."""
    from torch.profiler import ProfilerActivity, profile

    from ssad_tpu_torch.serving.export import ServedScorer

    meta = {"mode": "image", "batch": 2, "imsize": [84, 84], "k": 1, "threshold": 0.5,
            "model": dataclasses.asdict(ModelConfig(backbone=TINY, compute_dtype="float32"))}
    scorer = ServedScorer(meta, tiny_state(), "cpu", bank=torch.randn(8, 512))
    x = seeded.images(2, 84, 5, "requests", CPU).numpy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            scorer(x)
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.name.startswith(("ssad.image.forward", "ssad.vit.")))
    forwards = [(a, b) for a, b, n in ops if n == "ssad.image.forward"]
    assert len(forwards) == 2
    for a, b in forwards:
        inside = [n for s, e, n in ops if a <= s and e <= b and n != "ssad.image.forward"]
        assert inside == ["ssad.vit.embed", "ssad.vit.blocks", "ssad.vit.taps"]


def test_cnn_only_paths_refuse_the_trunk(tiny, tmp_path):
    from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint
    from ssad_tpu_torch.train.trainer import Trainer

    sd = tiny_state()
    model = port_model(sd)
    engine = InferenceEngine(model, CPU)
    x = normalize(images(1, 84, 84, seed=4))
    with pytest.raises(ValueError, match="patch mode.*'vit_tiny'"):
        engine.score_maps(x, lambda e: e[:, 0], dim=28, stride=14)
    with pytest.raises(ValueError, match="patch mode.*'vit_tiny'"):
        engine.patch_forward(torch.zeros(2, 28, 28, 3))
    with pytest.raises(ValueError, match="Grad-CAM.*'vit_tiny'"):
        compute_gradcam(model, x)
    ckpt, _ = _tiny_artifact(tmp_path, sd, torch.randn(10, 512), 0)
    with pytest.raises(ValueError, match="patch mode.*'vit_tiny'"):
        export_checkpoint(ckpt, tmp_path / "p.ssadpt", mode="patch", imsize=(84, 84),
                          normality=torch.randn(10, 512), device="cpu")
    meta = {"mode": "patch", "batch": 1, "imsize": [84, 84], "k": 1, "threshold": 0.5,
            "patch_dim": 28, "stride": 14, "upsample_to": 84,
            "model": dataclasses.asdict(ModelConfig(backbone=TINY))}
    with pytest.raises(ValueError, match="patch mode.*'vit_tiny'"):
        ServedScorer(meta, sd, "cpu", bank=torch.randn(8, 512))
    cfg = dataclasses.replace(TrainConfig(), model=ModelConfig(backbone=TINY))
    with pytest.raises(ValueError, match="training.*'vit_tiny'"):
        Trainer(cfg, data=None, device="cpu")
    # the published preset names itself, with no weight allocated
    with torch.device("meta"):
        giant = build_model(ModelConfig(backbone="dinov2_vitg14_reg"))
    with pytest.raises(ValueError, match="Grad-CAM.*'dinov2_vitg14_reg'"):
        compute_gradcam(giant, torch.zeros(1, 448, 448, 3, device="meta"))


@pytest.mark.parametrize("hw", [(84, 90), (80, 84)])
def test_sides_not_multiples_of_14_are_refused(tiny, hw):
    model = port_model(tiny_state())
    with pytest.raises(ValueError, match="multiples of 14"):
        with torch.inference_mode():
            model(torch.zeros(1, *hw, 3))


def test_make_backbone_lists_the_transformer():
    with pytest.raises(ValueError, match="dinov2_vitg14_reg"):
        peranet.make_backbone("vit_huge")


def test_int8_keeps_the_token_tables(tiny):
    from ssad_tpu_torch.serving.quant import dequantize_state_dict, quantize_state_dict

    sd = tiny_state()
    q, scales = quantize_state_dict(sd)
    fe = "feature_extractor."
    for name in ("cls_token", "register_tokens", "mask_token", "pos_embed",
                 "blocks.0.ls1.gamma", "blocks.0.norm1.weight", "blocks.0.attn.qkv.bias",
                 "norm.bias"):
        assert fe + name not in scales and torch.equal(q[fe + name], sd[fe + name])
    for name in ("patch_embed.proj.weight", "blocks.0.attn.qkv.weight",
                 "blocks.0.attn.proj.weight", "blocks.3.mlp.w12.weight", "blocks.3.mlp.w3.weight"):
        assert q[fe + name].dtype == torch.int8 and scales[fe + name].shape == (sd[fe + name]
                                                                                .shape[0],)
    back = dequantize_state_dict(q, scales)
    w = fe + "blocks.0.mlp.w12.weight"
    step = scales[w].view(-1, 1)
    # half a quantization step, then the rounding to bf16 values
    assert bool(((back[w].float() - sd[w]).abs() <= 0.5 * step + sd[w].abs() * 2**-8).all())
    m = port_model({k: v.float() if v.is_floating_point() else v for k, v in back.items()})
    with torch.inference_mode():
        assert torch.isfinite(m(normalize(images(1, 70, 70, seed=5)))["classifier"]).all()
