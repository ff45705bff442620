"""``vit_pointwise_ms`` (the transformer trunk's pointwise passes) on a
hand-built ``core.trace.Trace``: the library's elementwise and LayerNorm
passes and csrc/vit_pointwise.cu's kernels are counted; the products, the
attention, the k-NN, the copies, a reduction and a kernel of a name the
metric does not know (a hand-written attention, say) are left out; the sum
is per ``knn_cluster_kernel`` batch; a ResNet cell, a patch cell and a run
without a trace read None."""

import json

import pytest

from pb_helpers import ROOT
from port_bench.core import manifest
from port_bench.core.trace import Trace

CONFIGS = ROOT / "port_bench" / "configs"
VIT = json.loads((CONFIGS / "peranet_dinov2_vitg14_reg.json").read_text())
R18 = json.loads((CONFIGS / "peranet_r18.json").read_text())

#: (name, µs) of one batch's device work; ``counted`` marks what the metric sums
BATCH = [
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 900.0, False),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", 300.0, False),
    ("ampere_bf16_s16816gemm_bf16_128x64", 200.0, False),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>", 100.0, False),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>", 700.0, False),
    ("void (anonymous namespace)::knn_cluster_kernel<3>", 50.0, False),
    ("Memcpy HtoD (Pinned -> Device)", 40.0, False),
    ("Memset (Device)", 5.0, False),
    ("void at::native::elementwise_kernel<128, 4, gpu_kernel_impl<MulFunctor>>", 210.0, True),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", 190.0, True),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>", 156.0, True),
    ("void at::native::vectorized_elementwise_kernel<4, direct_copy_kernel_cuda>", 60.0, True),
    ("void (anonymous namespace)::residual_ln_kernel<__nv_bfloat16, true, true>", 180.0, True),
    ("void (anonymous namespace)::silu_mul_kernel<__nv_bfloat16>", 240.0, True),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, MeanOps<float>>>", 30.0, False),
    ("void (anonymous namespace)::vit_attention_kernel<64>", 400.0, False),
    ("void fused_gemm_epilogue_kernel<bf16>", 120.0, False),
]


def trace(batches=2):
    device, t = [], 0.0
    for _ in range(batches):
        for name, us, _ in BATCH:
            device.append((name, t, t + us))
            t += us + 1.0
    return Trace(device, [], wall_s=t / 1e6)


def test_counts_the_pointwise_passes_per_batch():
    read = manifest.reader("vit_pointwise_ms")
    expected = sum(us for _, us, counted in BATCH if counted) / 1e3
    for batches in (1, 3):
        value = read({"mode": "image", "trace": trace(batches), "config": VIT})
        assert value == pytest.approx(expected)
    # without the library's passes: the fused kernels alone
    fused = Trace([e for e in trace(2).device if "at::native" not in e[0]], [], 1.0)
    assert read({"mode": "image", "trace": fused, "config": VIT}) == pytest.approx(
        (180.0 + 240.0) / 1e3)


def test_reads_nothing_where_there_is_nothing_to_read():
    read = manifest.reader("vit_pointwise_ms")
    assert read({"mode": None, "trace": None}) is None
    assert read({"mode": "image", "trace": None, "config": VIT}) is None
    assert read({"mode": "image", "trace": trace(), "config": R18}) is None
    assert read({"mode": "patch", "trace": trace(), "config": VIT}) is None
    no_batch = Trace([e for e in trace().device if "knn_" not in e[0]], [], 1.0)
    assert read({"mode": "image", "trace": no_batch, "config": VIT}) is None


def test_the_manifest_lists_it_for_the_vit_cell():
    entry = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}["vit_pointwise_ms"]
    assert entry["workloads"] == ["vitg14_image_serve"]
    assert entry["moves"] == "image_verdicts_per_s" and entry["source"] == "device_trace"
    names = [m.name for m in manifest.resolve_cell("vitg14_image_serve").per_layer]
    assert "vit_pointwise_ms" in names
    assert "vit_pointwise_ms" not in [m.name for m in
                                      manifest.resolve_cell("r18_image_serve").per_layer]
