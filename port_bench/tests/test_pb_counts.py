"""The work counts of port_bench/counts against hand-worked numbers at two
shapes each, and the model's FLOPs against the port's modules counted by
forward hooks on the CPU."""

import pytest
import torch

from port_bench.counts import PEAKS, kernels, model


def test_stem_counts():
    # 2·n·32·32·64·48 products; bf16 windows in, (16, 16, 64) bf16 out,
    # the 48×64 bf16 kernel and two f32 vectors of 64 read once
    assert kernels.stem(1) == (6_291_456.0, 45_568.0)
    assert kernels.stem(6728) == (42_328_915_968.0, 261_806_592.0)


def test_knn_counts():
    assert kernels.knn(8, 700, 512) == (5_734_400.0, 1_450_016.0)
    assert kernels.knn(6728, 123_038, 512) == (847_666_855_936.0, 265_787_680.0)


def test_bound():
    t, by = kernels.bound_s(*kernels.knn(6728, 123_038, 512))
    assert by == "operations" and t == pytest.approx(847_666_855_936 / 989e12)
    t, by = kernels.bound_s(*kernels.knn(8, 700, 512))
    assert by == "bytes" and t == pytest.approx(1_450_016 / PEAKS["hbm_bytes_per_s"])


def test_resnet18_trunk():
    # 224²: stem 112²·64·147, layer1 4 × 56²·64·64·9, and per later stage
    # its strided first conv, three full convs and the 1×1 projection
    stages = 3 * (57_802_752 + 3 * 115_605_504 + 6_422_528)
    assert model.trunk_macs("resnet18", 224, 224)[0] == 118_013_952 + 4 * 115_605_504 + stages
    # a 32×32 window: the folded stem 32²·64·48, then 16², 8², 4², 2² maps
    stages = 3 * (4_718_592 + 3 * 9_437_184 + 524_288)
    assert model.trunk_macs("resnet18", 32, 32)[0] == 3_145_728 + 4 * 9_437_184 + stages


def test_wide_resnet50_2_trunk():
    # torchvision's published 11.40 GMACs at 224², less its 2048×1000 fc
    assert model.trunk_macs("wide_resnet50_2", 224, 224)[0] == pytest.approx(
        11.398e9 - 2_048_000, rel=1e-3)


def test_head():
    widths = [64, 128, 256, 512]
    assert model.head_macs(widths, ("layer2", "layer3"), 5, 512, 4) == (
        896 * 512 + 4 * 512 * 512 + 512 * 4)


def _hooked_macs(net, x):
    total = [0]

    def conv(mod, inp, out):
        total[0] += out[0].numel() * mod.in_channels // mod.groups * mod.kernel_size[0] \
            * mod.kernel_size[1]

    def dense(mod, inp, out):
        total[0] += out.shape[-1] * mod.in_features * (out.numel() // out.shape[0]
                                                       // out.shape[-1])

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(dense)
    with torch.no_grad():
        net(x)
    return total[0]


@pytest.mark.parametrize("backbone", ["resnet18", "wide_resnet50_2"])
@pytest.mark.parametrize("size", [64, 96])
def test_forward_flops_match_the_port(backbone, size):
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model

    cfg = {"backbone": backbone, "layer_outputs": ["layer2", "layer3"],
           "latent_space_layers": 5, "latent_dim": 512, "num_classes": 4}
    net = build_model(ModelConfig(backbone=backbone, compute_dtype="float32")).eval()
    macs = _hooked_macs(net, torch.zeros(1, size, size, 3))
    assert model.forward_flops(cfg, size, size) == 2 * macs


def test_patch_map_flops():
    cfg = {"backbone": "resnet18", "layer_outputs": ["layer2", "layer3"],
           "latent_space_layers": 5, "latent_dim": 512, "num_classes": 4}
    per_window = 2 * (141_557_760 + 1_509_376)
    assert model.patch_map_flops(cfg, 256, 32, 8, 1000) == 841 * per_window + 2 * 841 * 1000 * 512
