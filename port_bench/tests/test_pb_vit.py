"""The transformer cell's files: a tiny ViT cell through ``serve_closed_vit``
on the CPU comes out ``correct``, and not ``correct`` with the timed path
broken or with a fault planted in the port's trunk (``planted``): a wrong
softmax scale, values taken from the wrong head, a skipped block, the
position table left out, the taps one block early; on the card
(``card``) the same faults fail the real cell at its own size;
``counts/vit.py`` against counts worked by hand; its readers read nothing
without a trace.

The tiny cell runs a DINOv2 trunk at tiny widths (width 32, 4 blocks, 4
heads, a 5 × 5 position table resampled to the 6 × 6 grid of 84² images),
entered under one name in the port's backbone table and the reference's."""

import contextlib
import importlib.util
import json
import shutil

import pytest
import torch
import torch.nn.functional as F

from pb_helpers import ROOT, run_cell
from port_bench.core import manifest, seeded
from port_bench.counts import kernels, vit
from port_bench.reference import vit as ref_vit

TINY = "vit_tiny_test"
TINY_ARCH = dict(embed_dim=32, depth=4, num_heads=4, hidden=88, patch=14, grid=5, registers=4)
TINY_TRAFFIC = dict(imsize=84, batch=4, clients=6, normality_images=40, normality_batch=8,
                    pool_images=16, sample=16)
CELL, CONFIG, TRAFFIC = "vitg14_image_serve", "peranet_dinov2_vitg14_reg", "image_closed64_448"
#: faults ``planted`` can put in the port's trunk
FAULTS = ("softmax_scale_1", "v_from_next_head", "block_skipped", "no_positions",
          "taps_one_block_early")


@contextlib.contextmanager
def planted(fault: str):
    """The port's trunk (models/vit.py) with one fault while the context is
    open, in every model built inside it: ``softmax_scale_1`` the attention
    scores not divided by √64; ``v_from_next_head`` each head's values
    taken from the next head; ``block_skipped`` the middle block left out;
    ``no_positions`` no position table added; ``taps_one_block_early`` the
    taps after blocks depth/4 − 1, ... (DINOv2's indices taken as 1-based)."""
    from ssad_tpu_torch.models import vit as pvit

    saved = []

    def put(owner, name, value):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    if fault in ("softmax_scale_1", "v_from_next_head"):
        def attention(self, x):
            b, n, c = x.shape
            qkv = pvit._linear(x, self.qkv).view(b, n, 3, self.num_heads, c // self.num_heads)
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
            if fault == "v_from_next_head":
                v = v.roll(-1, dims=1)
            o = F.scaled_dot_product_attention(
                q, k, v, scale=1.0 if fault == "softmax_scale_1" else None)
            return pvit._linear(o.transpose(1, 2).reshape(b, n, c), self.proj)

        put(pvit.Attention, "forward", attention)
    elif fault == "no_positions":
        positions = pvit.VisionTransformer.positions
        put(pvit.VisionTransformer, "positions",
            lambda self, gh, gw: torch.zeros_like(positions(self, gh, gw)))
    elif fault in ("block_skipped", "taps_one_block_early"):
        init, block = pvit.VisionTransformer.__init__, pvit.Block.forward

        def marked(self, *args, **kwargs):
            init(self, *args, **kwargs)
            if fault == "block_skipped":
                self.blocks[len(self.blocks) // 2].skipped = True
            else:
                self.tap_blocks = tuple(t - 1 for t in self.tap_blocks)

        put(pvit.VisionTransformer, "__init__", marked)
        put(pvit.Block, "forward", lambda self, x: x if getattr(self, "skipped", False)
            else block(self, x))
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


@pytest.fixture()
def tiny_vit(monkeypatch):
    """The tiny trunk under ``TINY`` in the port's and the reference's tables."""
    from ssad_tpu_torch.models import vit as port_vit
    from ssad_tpu_torch.models.vit import VisionTransformer

    monkeypatch.setitem(ref_vit.ARCHS, TINY, TINY_ARCH)
    monkeypatch.setitem(port_vit.BACKBONES, TINY, lambda dtype: VisionTransformer(
        embed_dim=32, depth=4, num_heads=4, patch_size=14, img_size=70,
        num_register_tokens=4, dtype=dtype))


def add_tiny_vit_cell(root, name="tiny_vit"):
    """The manifest, the real cell's limits and the ViT configuration and
    traffic at tiny sizes, copied into ``root`` as a later change adds a
    cell."""
    bench = root / "port_bench"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    manifest_path = root / "BENCHMARK.json"
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": name, "source": "tiny", "file": f"port_bench/configs/{name}.json",
                         "reduced": [], "why": "a tiny CPU cell of the harness tests"})
    m["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1,
                           "why": "a tiny CPU cell of the harness tests"})
    for group in ("end_to_end", "per_layer"):
        for e in m[group]:
            if CELL in e.get("workloads", []):
                e["workloads"].append(name)
    manifest_path.write_text(json.dumps(m))
    cfg = json.loads((ROOT / "port_bench" / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(name=name, backbone=TINY)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "port_bench" / "traffic" / f"{TRAFFIC}.json").read_text())
    traffic.update(TINY_TRAFFIC)
    (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "port_bench" / "workloads" / f"{CELL}.json",
                bench / "workloads" / f"{name}.json")
    return name


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_vit_cell_is_correct(tmp_path, capsys, tiny_vit, trace):
    cell = add_tiny_vit_cell(tmp_path)
    rc, line = run_cell(tmp_path, cell, trace=trace, capsys=capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and list(line)[-1] == "checks"
    if trace:
        m = line["metrics"]
        assert "mfu.vit" in m and "vit_blocks_launch_ms" in m and "scorer_ms.image" in m
        assert "mfu.image" not in m
        # no flash kernel runs on the CPU, so the share has nothing to read
        assert "attention_roofline" not in m
    else:
        assert set(line["metrics"]) == {"image_verdicts_per_s", "setup_s"}


def test_tiny_vit_cell_with_an_altered_answer_is_not_correct(tmp_path, capsys, monkeypatch,
                                                             tiny_vit):
    from ssad_tpu_torch.serving import export

    cell = add_tiny_vit_cell(tmp_path)
    traffic = tmp_path / "port_bench" / "traffic" / f"{cell}.json"
    t = json.loads(traffic.read_text())
    t.update(sample=10**6, pool_images=4)  # every request checked
    traffic.write_text(json.dumps(t))
    score_tensor = export.ServedScorer.score_tensor

    def broken(self, x):
        out = score_tensor(self, x)
        first = out[0].clone()
        first[0] = first[0] * 1.5 + 0.05
        return (first,) + tuple(out[1:])

    monkeypatch.setattr(export.ServedScorer, "score_tensor", broken)
    rc, line = run_cell(tmp_path, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("fault", FAULTS)
def test_tiny_vit_cell_with_a_planted_fault_is_not_correct(tmp_path, capsys, tiny_vit, fault):
    cell = add_tiny_vit_cell(tmp_path)
    with planted(fault):
        rc, line = run_cell(tmp_path, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _control():
    spec = importlib.util.spec_from_file_location("pb_control",
                                                  ROOT / "port_bench" / "control.py")
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    return control


#: the card test's seed
CARD_SEED = 3100000071


@pytest.fixture(scope="module")
def card_reference():
    """(cell, control module, sampled pool indices, the reference's outputs)
    for the real cell at ``CARD_SEED``, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: port_bench/README.md)")
    cell, control = manifest.resolve_cell(CELL), _control()
    drv = manifest.driver(cell.traffic["driver"])
    picks = control.sample_pool(cell.traffic, CARD_SEED)
    ref = drv.reference_outputs(cell.config, cell.traffic, CARD_SEED, torch.device("cuda"),
                                picks, flip_band=cell.limits["score_gap"])
    return cell, control, picks, ref


@pytest.mark.card
@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_planted_faults_fail_the_cell_on_the_card(cuda_device, card_reference, fault):
    """The real cell's set-up and a sample of its requests, scored directly
    (``control.direct_outputs``): sound, every limit holds; with each fault,
    one fails.  Prints the numbers."""
    cell, control, picks, ref = card_reference
    drv = manifest.driver(cell.traffic["driver"])
    cfg, tr = cell.config, cell.traffic
    state = seeded.fill_state(drv.shapes(cfg), CARD_SEED, cuda_device)
    with planted(fault) if fault else contextlib.nullcontext():
        scorer, _, threshold = drv.build_scorer(cfg, tr, state, CARD_SEED, cuda_device)
        images = seeded.images(tr["pool_images"], tr["imsize"], CARD_SEED, "requests",
                               cuda_device).cpu().numpy()[picks]
        out = control.direct_outputs(scorer, images, "image", threshold, tr["batch"])
    del scorer, state
    drv.free(cuda_device)
    numbers = drv.compare("image", out, ref)
    print(json.dumps({"fault": fault, "numbers": numbers}))
    failed = [n for n, limit in cell.limits.items() if numbers[n] > limit]
    assert bool(failed) == (fault is not None), numbers


def test_the_vit_driver_keeps_serve_closeds_names():
    """control.py calls these on any driver."""
    drv = manifest.driver("serve_closed_vit")
    base = manifest.driver("serve_closed")
    for name in ("build_scorer", "drive", "compare", "program_outputs", "sample", "free",
                 "TimedScorer"):
        assert getattr(drv, name).__qualname__ == getattr(base, name).__qualname__
    for name in ("shapes", "build_scorer", "reference_outputs"):
        assert getattr(drv, name) is not getattr(base, name)
    # the freshly loaded serve_closed keeps its own
    assert base.shapes.__module__ == base.__name__


def test_vit_counts_by_hand():
    b = "dinov2_vitg14_reg"
    assert vit.tokens(b, 448, 448) == 1 + 4 + 32 * 32 == 1029
    n = 1029
    per_block = (n * 1536 * 4608 + 2 * 24 * n * n * 64 + n * 1536 * 1536 + n * 1536 * 8192
                 + n * 4096 * 1536)
    assert per_block == 32_385_346_560
    patch = 1024 * 1536 * 3 * 14 * 14
    assert vit.trunk_macs(b, 448, 448) == patch + 40 * per_block == 1_296_338_706_432
    cfg = {"backbone": b, "layer_outputs": ["layer2", "layer3"], "latent_space_layers": 5,
           "latent_dim": 512, "num_classes": 4}
    head = 4608 * 512 + 4 * 512 * 512 + 512 * 4
    assert vit.verdict_flops(cfg, 448, 448, 146) == 2 * (1_296_338_706_432 + head) \
        + 2 * 146 * 512
    assert round(vit.verdict_flops(cfg, 448, 448, 146) / 1e12, 3) == 2.593
    ops, nbytes = vit.attention(32, b, 448, 448)
    assert ops == 4 * 32 * 24 * n * n * 64 == 208_176_611_328
    assert nbytes == 2 * 4 * 32 * n * 1536
    t, by = kernels.bound_s(ops, nbytes)
    assert by == "operations" and t == pytest.approx(210.5e-6, rel=1e-3)
    # the uninterpolated 518² grid: 37² patches
    assert vit.tokens(b, 518, 518) == 1 + 4 + 37 * 37


@pytest.mark.parametrize("metric", ["mfu.vit", "attention_roofline", "vit_blocks_launch_ms"])
def test_vit_readers_read_nothing_without_a_trace(metric):
    read = manifest.reader(metric)
    cfg = json.loads((ROOT / "port_bench" / "configs" / f"{CONFIG}.json").read_text())
    assert read({"mode": None, "trace": None}) is None
    if metric != "mfu.vit":  # mfu reads the host clock, no trace
        assert read({"mode": "image", "trace": None, "config": cfg}) is None
    # a ResNet cell has nothing for them to read
    r18 = json.loads((ROOT / "port_bench" / "configs" / "peranet_r18.json").read_text())
    assert read({"mode": "image", "trace": None, "config": r18}) is None


def test_state_shapes_count_the_published_trunk():
    shapes = ref_vit.state_shapes("dinov2_vitg14_reg")
    trunk = sum(torch.Size(s).numel() for k, s in shapes.items()
                if k.startswith("feature_extractor."))
    assert trunk == 1_136_486_912
    assert shapes["concatenator.0.weight"] == (512, 4608)
