"""FLOPs of PeraNet's forward from its configuration and input size: every
convolution and dense product, 2 per multiply-add; BatchNorm, ReLU,
pooling and the means are left out (a few per element, under 1 % here).

A 32×32 window counts its stem as the folded 4×4/s1 conv (48 products per
output: nearest-×2 upsampling + the 7×7/s2 conv need no more); a larger
input counts the 7×7/s2 conv (147 per output) on the input, upsampled to
64 px where it is smaller.  A patch map adds its windows' k-NN products;
an image verdict its row's."""

from __future__ import annotations

from port_bench.counts import kernels

STAGE_FILTERS = (64, 128, 256, 512)
#: backbone → (block, blocks per stage, inner-width factor)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 2),
}


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def trunk_macs(backbone: str, h: int, w: int) -> int:
    """Multiply-adds of the stem and the four stages; also returns the
    stage widths (layer1..layer4)."""
    block, stages, factor = ARCHS[backbone]
    if (h, w) == (32, 32):
        macs, h, w = 32 * 32 * 64 * 48, 32, 32
    else:
        h, w = max(h, 64), max(w, 64)
        h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
        macs = h * w * 64 * 7 * 7 * 3
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    widths = []
    for stage, (blocks, filters) in enumerate(zip(stages, STAGE_FILTERS), start=1):
        for b in range(blocks):
            s = 2 if stage > 1 and b == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            if block == "basic":
                cout = filters
                macs += ho * wo * cout * cin * 9 + ho * wo * cout * cout * 9
            else:
                inner, cout = filters * factor, filters * 4
                macs += (h * w * inner * cin + ho * wo * inner * inner * 9
                         + ho * wo * cout * inner)
            if s != 1 or cin != cout:
                macs += ho * wo * cout * cin
            h, w, cin = ho, wo, cout
        widths.append(cin)
    return macs, widths


def head_macs(widths, layer_outputs, latent_space_layers: int, latent_dim: int,
              num_classes: int) -> int:
    taps = {f"layer{i}": c for i, c in enumerate(widths, start=1)}
    in_dim = sum(taps[t] for t in layer_outputs) + taps["layer4"]
    return (in_dim * latent_dim + (latent_space_layers - 1) * latent_dim * latent_dim
            + latent_dim * num_classes)


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of one input's forward (trunk + head) for a configuration file."""
    trunk, widths = trunk_macs(cfg["backbone"], h, w)
    head = head_macs(widths, cfg["layer_outputs"], cfg["latent_space_layers"],
                     cfg["latent_dim"], cfg["num_classes"])
    return 2.0 * (trunk + head)


def patch_map_flops(cfg: dict, imsize: int, dim: int, stride: int, bank_rows: int) -> float:
    """One anomaly map: every window's forward and k-NN products."""
    side = (imsize - dim) // stride + 1
    n = side * side
    return n * forward_flops(cfg, dim, dim) + kernels.knn(n, bank_rows, cfg["latent_dim"])[0]


def image_verdict_flops(cfg: dict, imsize: int, bank_rows: int) -> float:
    """One image verdict: the forward and its row's k-NN products."""
    return forward_flops(cfg, imsize, imsize) + kernels.knn(1, bank_rows, cfg["latent_dim"])[0]
