"""The port's ResNet family (basic and bottleneck blocks) against the JAX
package's, through the weight bridge.

Seeded numpy values fill a JAX PeraNet's variables (shaped by
``eval_shape`` of its init); ``utils/jax_bridge.state_dict_from_jax``
carries them into the port, and both run the same inputs.  The
bottleneck models are the JAX ``ResNet`` class at shallow depth
(``stage_sizes=(1, 1, 1, 1)``): each package's ``make_backbone`` is
swapped for one that builds it, so the PeraNet around it is the real one
(3,584 → 512 head for bottleneck blocks).  The four architectures at
their real depth are held by parameter shapes only.

Tolerances: f32 1e-5 (summation order only); bf16 compute 5e-3, the
ResNet-18 tolerance of tests/test_torch_models.py (the two frameworks
round their bf16 convolutions at different places); the train-mode
forward and the stem's windows say theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import seeded
from _torch_step_parity import CPU_LIMITS

from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.evaluation.inference import InferenceEngine as JInferenceEngine
from ssad_tpu.models import peranet as jperanet
from ssad_tpu.models import resnet as jresnet
from ssad_tpu.utils.torch_weights import convert_resnet_state_dict as jax_convert
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.models import peranet, resnet
from ssad_tpu_torch.ops.image import normalize_imagenet
from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax
from ssad_tpu_torch.utils.torch_weights import convert_resnet_state_dict, load_resnet18_into

torch.set_num_threads(1)

SHALLOW = (1, 1, 1, 1)
#: (block, width_factor) of the shallow models
BLOCKS = [("basic", 1), ("bottleneck", 1), ("bottleneck", 2)]
ARCHS = ["resnet18", "resnet34", "resnet50", "wide_resnet50_2"]


def _seeded_tree(tree, rng, kind, fresh=False):
    """Seeded numpy leaves shaped like ``tree``: conv and dense kernels of
    std 1/√fan_in, BN scales near 1, small biases; running means near 0
    and variances in [0.5, 2].  ``fresh``: as a Flax init leaves them
    (scales 1, biases 0, running means 0 and variances 1)."""
    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, x.shape).astype(np.float32)
        if fresh:
            return np.full(x.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)
        if kind == "stats":
            return (rng.normal(0, 0.1, x.shape) if name == "mean"
                    else rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return rng.normal(0, 0.05, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _models(monkeypatch, block, width_factor, compute_dtype, stages=SHALLOW, seed=0,
            fresh=False):
    """(JAX PeraNet, params, batch_stats, the port's PeraNet with the same
    weights through the bridge) for a ResNet of ``stages`` depths."""
    jdtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    monkeypatch.setattr(jperanet, "make_backbone", lambda arch, dtype, name: jresnet.ResNet(
        dtype=dtype, stage_sizes=stages, block=block, width_factor=width_factor, name=name))
    monkeypatch.setattr(peranet, "make_backbone", lambda arch, dtype: resnet.ResNet(
        stages, dtype=dtype, block=block, width_factor=width_factor))
    jmodel = jperanet.build_model(JModelConfig(compute_dtype=compute_dtype))
    assert jmodel.compute_dtype == jdtype
    tmpl = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(seed)
    params = _seeded_tree(tmpl["params"], rng, "params", fresh)
    stats = _seeded_tree(tmpl["batch_stats"], rng, "stats", fresh)
    model = peranet.build_model(ModelConfig(compute_dtype=compute_dtype))
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jmodel, params, stats, model


@pytest.mark.parametrize("block,width_factor", BLOCKS)
@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_peranet_eval_matches_jax(monkeypatch, block, width_factor, compute_dtype, tol):
    jmodel, params, stats, model = _models(monkeypatch, block, width_factor, compute_dtype)
    assert model.concatenator[0].in_features == (3584 if block == "bottleneck" else 896)
    x = seeded((2, 64, 64, 3), 3)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x))
    for key in ("classifier", "latent_space"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("block,width_factor", BLOCKS[1:])
def test_patch_windows_through_the_stem_match_jax(monkeypatch, block, width_factor):
    """32×32 windows of a bottleneck model take the fused stem (its plain
    version on the CPU) and re-enter after the maxpool, as in the JAX
    engine.  Embeddings within 1e-3, the patch path's tolerance
    (tests/test_torch_patch_path.py): both sides round the stem's f32 sums
    to bf16, in other orders, so one value may flip by a bf16 ulp."""
    jmodel, params, stats, model = _models(monkeypatch, block, width_factor, "float32")
    x = seeded((1, 48, 48, 3), 6, -2.0, 2.0)
    _, jemb, jn = JInferenceEngine(jmodel, params, stats).predict_patches(x, 32, 8)
    _, emb, n = InferenceEngine(model, "cpu").predict_patches(torch.from_numpy(x), 32, 8)
    assert n == jn == 9
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0, atol=1e-3)


def test_bottleneck_train_mode_forward_matches_jax(monkeypatch):
    """One train-mode forward of a wide bottleneck model as initialised
    (BatchNorms as Flax leaves them) on ImageNet-normalised 64² images,
    batch 8 — the setting of ``_torch_step_parity.CPU_LIMITS``: logits from the batch statistics
    and every updated running statistic (Flax's biased variance, momentum
    0.9).  Statistics within 1e-5 (rtol and atol; measured 8.6e-6
    absolute, 0.42 of the tolerance).  Logits are held to
    ``CPU_LIMITS["logits"]`` = 3e-4, not 1e-5 (measured 2.3e-4 on logits
    of scale 2.5; 1.4e-4 and 1.5e-4 from seeds 1 and 2): each train-mode BatchNorm divides by
    its batch's standard deviation, which for a channel of small spread
    magnifies the one-ulp differences of the two summation orders by up to
    1/√eps; a ResNet-18 step reads the same (tests/test_torch_train_step.py)."""
    jmodel, params, stats, model = _models(monkeypatch, "bottleneck", 2, "float32",
                                           fresh=True)
    before = state_dict_from_jax(params, stats)
    x = normalize_imagenet(torch.from_numpy(seeded((8, 64, 64, 3), 8))).numpy()
    ref, new = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    out = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out["classifier"].detach().numpy(),
                               np.asarray(ref["classifier"]), rtol=0,
                               atol=CPU_LIMITS["logits"])
    want = state_dict_from_jax(params, jax.tree.map(np.asarray, new["batch_stats"]))
    got = model.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * sum(isinstance(m, resnet.FlaxBatchNorm) for m in model.modules())
    for k in stat_keys:
        assert not torch.equal(got[k], before[k]), f"{k} was not updated"
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_architecture_has_the_jax_shapes_at_full_depth(arch):
    """The four backbones at their published depths: the JAX PeraNet's
    variables, carried through the bridge, are exactly the port's keys and
    shapes (the bridge on every architecture's tree)."""
    jmodel = jperanet.build_model(JModelConfig(backbone=arch))
    tmpl = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tmpl)
    want = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    got = peranet.build_model(ModelConfig(backbone=arch)).state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in got)


def _torchvision_state_dict(arch: str, seed: int = 0) -> dict:
    """Seeded random tensors with torchvision ``arch``'s keys and shapes
    (``fc.*`` and ``num_batches_tracked`` included)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in resnet.make_backbone(arch).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
    width = resnet.make_backbone(arch).stage_channels["layer4"]
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, width), torch.zeros(1000)
    return sd


def _head_tree(batch_stats: bool) -> dict:
    """A minimal PeraNet head (no latent blocks), for the bridge."""
    z = np.zeros(2, np.float32)
    if batch_stats:
        return {"concatenator_bn": {"mean": z, "var": z}, "latent_out_bn": {"mean": z, "var": z}}
    dense = {"kernel": np.zeros((2, 2), np.float32)}
    return {"concatenator_dense": dense, "concatenator_bn": {"scale": z, "bias": z},
            "latent_out_dense": dict(dense, bias=z), "latent_out_bn": {"scale": z, "bias": z},
            "classifier": dict(dense, bias=z)}


@pytest.mark.parametrize("arch", ["resnet50", "wide_resnet50_2"])
def test_torchvision_converter_matches_jax(arch):
    """The port's converter on a torchvision-layout file equals the JAX
    converter's trees taken through the bridge, key for key, bit for bit."""
    sd = _torchvision_state_dict(arch)
    got = convert_resnet_state_dict(sd)
    params, stats = jax_convert({k: v.numpy() for k, v in sd.items()})
    bridged = state_dict_from_jax(dict(_head_tree(False), backbone=params),
                                  dict(_head_tree(True), backbone=stats))
    pre = "feature_extractor."
    want = {k[len(pre):]: v for k, v in bridged.items()
            if k.startswith(pre) and not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_pretrained_resnet50_loads(tmp_path):
    """``load_resnet18_into`` (the JAX package's name) takes a resnet50
    file into a resnet50 PeraNet and refuses it for a resnet18 one."""
    sd = _torchvision_state_dict("resnet50", seed=1)
    torch.save(sd, tmp_path / "resnet50.pth")
    model = peranet.build_model(ModelConfig(backbone="resnet50"))
    load_resnet18_into(model, tmp_path / "resnet50.pth")
    for k, v in model.feature_extractor.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="not a torchvision state dict of this backbone"):
        load_resnet18_into(peranet.build_model(ModelConfig()), tmp_path / "resnet50.pth")


def test_make_backbone_refuses_an_unknown_name_as_jax_does():
    with pytest.raises(ValueError) as jerr:
        jresnet.make_backbone("vgg16")
    with pytest.raises(ValueError) as err:
        resnet.make_backbone("vgg16")
    assert str(err.value) == str(jerr.value)
    assert "resnet18 | resnet34 | resnet50 | wide_resnet50_2" in str(err.value)
    alias = resnet.make_backbone("wide_resnet50")
    assert [p.shape for p in alias.parameters()] == \
        [p.shape for p in resnet.WideResNet50_2().parameters()]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_train_takes_every_backbone(arch, tmp_path):
    """``train --backbone`` reaches the model the trainer builds."""
    from ssad_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["train", "--dataset-dir", str(tmp_path), "--subject", "bottle", "--backbone", arch,
         "--pretrained-backbone", str(tmp_path / f"{arch}.pth")])
    cfg = cli._train_cfg(args)
    pth = str(tmp_path / f"{arch}.pth")
    assert (cfg.model.backbone, cfg.model.pretrained_backbone) == (arch, pth)
    width = 896 if arch in ("resnet18", "resnet34") else 3584
    assert peranet.build_model(cfg.model).concatenator[0].in_features == width
