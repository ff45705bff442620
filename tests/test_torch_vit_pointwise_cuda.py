"""The transformer trunk's pointwise kernels (csrc/vit_pointwise.cu) against
their plain PyTorch versions on the card.  Every test takes the
``cuda_device`` fixture, carries the ``card`` marker and skips where there
is no card.

Held, at the published shape (32 × 1,029 tokens, width 1,536, SwiGLU hidden
4,096) and at the tiny trunks' (width 32, hidden 88), bf16 and f32:
* the residual stream x' = x + gamma ⊙ y, the LayerNorm's output n and
  ``silu_mul`` bit for bit (the raw bits, NaN positions compared apart):
  the kernels make the library passes' IEEE operations in their order, the
  LayerNorm's Welford sums in the tree of PyTorch's CUDA kernel; the share
  of elements of n that differ and their largest distance in steps of the
  dtype are printed;
* one bf16 forward of the published trunk launches ``residual_ln`` 120
  times and ``silu_mul`` 40 times (3 and 1 a block), runs no library
  LayerNorm in its blocks, and stays within tests/test_torch_vit_cuda.py's
  tolerance of the plain reference;
* at the served shape each kernel takes less time than its plain version
  (CUDA events over back-to-back calls; printed with the kernel's device
  time under the profiler and the bytes bound).

This file imports neither JAX nor the JAX package:
    python -m pytest --noconftest -s tests/test_torch_vit_pointwise_cuda.py
"""

import json

import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)
from test_torch_vit_cuda import BACKBONE, BF16_TOL, SEED, port, rel

from port_bench.core import seeded
from port_bench.reference import vit as ref_vit
from port_bench.reference.peranet import exact_f32, normalize
from ssad_tpu_torch.models import vit
from ssad_tpu_torch.ops import vit_pointwise as vp

pytestmark = pytest.mark.card

BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
#: (rows as (B, N), width, hidden): ViT-g/14 at 448², and the tiny trunks
SHAPES = {"published": ((32, 1029), 1536, 4096), "tiny": ((3, 7), 32, 88)}
DTYPES = [torch.bfloat16, torch.float32]
HBM_BYTES_PER_S = 3.35e12


def same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(BITS[a.dtype]).masked_fill(nan, 0),
                            b.view(BITS[b.dtype]).masked_fill(nan, 0)))


def steps_apart(a, b):
    """|a − b| in steps of the dtype at the larger magnitude of the two."""
    a32, b32 = a.float(), b.float()
    big = torch.maximum(a32.abs(), b32.abs())
    exponent = torch.floor(torch.log2(big.clamp_min(torch.finfo(a.dtype).tiny)))
    return (a32 - b32).abs() / torch.exp2(exponent - MANTISSA[a.dtype])


def inputs(rows, width, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = rows + (width,)
    x = (torch.randn(shape, generator=gen, device=device)
         * (0.5 + 3 * torch.rand(rows + (1,), generator=gen, device=device))
         + 2 * torch.randn(rows + (1,), generator=gen, device=device))
    flat = x.view(-1)
    flat[::7] = torch.round(flat[::7] * 256) / 256 + 2.0 ** -9  # halfway between bf16 steps
    y = torch.randn(shape, generator=gen, device=device).to(dtype)
    y.view(-1)[1] = -0.0
    gamma = 1.0 + 0.2 * torch.randn(width, generator=gen, device=device)
    ln = (0.8 + 0.4 * torch.rand(width, generator=gen, device=device),
          0.1 * torch.randn(width, generator=gen, device=device), vit.LN_EPS)
    return x, y, gamma, ln


def launched(fn, counter, *args, **kwargs):
    before = counter.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_residual_ln_against_the_plain_version(cuda_device, shape, dtype):
    rows, width, _ = SHAPES[shape]
    x, y, gamma, ln = inputs(rows, width, dtype, cuda_device, seed=11)
    k = vp.residual_ln_cuda
    with torch.inference_mode():
        _, n_ln = launched(vp.residual_ln, k, x, ln=ln, dtype=dtype)
        x_both, n_both = launched(vp.residual_ln, k, x, y, gamma, ln, dtype)
        x_res, n_res = launched(vp.residual_ln, k, x, y, gamma)
        p_x, p_n = vp.residual_ln_plain(x, y, gamma, ln, dtype)
        _, p_n_ln = vp.residual_ln_plain(x, ln=ln, dtype=dtype)
    assert same(x_both, p_x) and same(x_res, p_x) and n_res is None
    assert x_both.data_ptr() != x.data_ptr()
    report = {"shape": shape, "dtype": str(dtype)}
    for form, n, p in (("ln", n_ln, p_n_ln), ("both", n_both, p_n)):
        assert n.dtype == dtype and n.shape == x.shape
        report[form] = {"max_steps": float(steps_apart(n, p).max()),
                        "share_differing": float((n != p).float().mean())}
    print(json.dumps({"residual_ln": report}))
    assert same(n_ln, p_n_ln) and same(n_both, p_n), report


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_silu_mul_against_the_plain_version(cuda_device, shape, dtype):
    rows, _, hidden = SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    h = (3 * torch.randn(rows + (2 * hidden,), generator=gen, device=cuda_device)).to(dtype)
    flat = h.view(-1)
    flat[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -100.0, -0.0, 0.0])
    flat[6::5] = (torch.round(flat[6::5].float() * 64) / 64 + 2.0 ** -8).to(dtype)
    with torch.inference_mode():
        out = launched(vp.silu_mul, vp.silu_mul_cuda, h)
        plain = vp.silu_mul_plain(h)
    assert out.is_contiguous() and same(out, plain)


def test_published_trunk_launches_and_tolerance(cuda_device):
    """One forward: 3 residual_ln and 1 silu_mul a block, no library
    LayerNorm but the taps' four, within the bf16 tolerance of the
    reference."""
    from torch.profiler import ProfilerActivity, profile

    state = seeded.fill_state(ref_vit.state_shapes(BACKBONE), SEED, cuda_device)
    x = normalize(seeded.images(2, 448, SEED, "requests", cuda_device))
    logits, emb = ref_vit.ViTPeraNetReference(state, BACKBONE).forward(x)
    model = port(state, "bfloat16")
    with exact_f32(), torch.inference_mode():
        model(x)  # the kernels built and loaded
        torch.cuda.synchronize()
        before = vp.residual_ln_cuda.launches, vp.silu_mul_cuda.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = model(x)
            torch.cuda.synchronize()
    launches = (vp.residual_ln_cuda.launches - before[0], vp.silu_mul_cuda.launches - before[1])
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps({"launches": launches, "logit_gap": rel(out["classifier"], logits),
                      "latent_gap": rel(out["latent_space"], emb)}))
    assert launches == (120, 40)
    assert sum("residual_ln_kernel" in n for n in names) == 120
    assert sum("silu_mul_kernel" in n for n in names) == 40
    norms = [n for n in names if "layer_norm" in n]
    assert len(norms) == 4, norms  # the taps' final norm
    assert rel(out["classifier"], logits) < BF16_TOL
    assert rel(out["latent_space"], emb) < BF16_TOL
    del model, state
    torch.cuda.empty_cache()


def _ms_per_call(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _device_us_per_call(fn, calls=10):
    """Mean device time of the kernel's launches under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("residual_ln_kernel" in e.name or "silu_mul_kernel" in e.name)]
    assert len(spans) == calls
    return sum(spans) / calls


def test_kernels_beat_their_plain_versions_at_the_served_shape(cuda_device):
    """µs a call at the served bf16 shape, kernel and plain (CUDA events),
    the kernel's device time (profiler), beside the bytes bound (each input
    read once, each output written once)."""
    rows, width, hidden = SHAPES["published"]
    dt = torch.bfloat16
    x, y, gamma, ln = inputs(rows, width, dt, cuda_device, seed=13)
    h = torch.randn(rows + (2 * hidden,), device=cuda_device).to(dt)
    elems, hid = x.numel(), h.numel() // 2
    cases = {  # name: (kernel, plain, bytes)
        "residual_ln.ln": (lambda: vp.residual_ln(x, ln=ln, dtype=dt),
                           lambda: vp.residual_ln_plain(x, ln=ln, dtype=dt), elems * (4 + 2)),
        "residual_ln.both": (lambda: vp.residual_ln(x, y, gamma, ln, dt),
                             lambda: vp.residual_ln_plain(x, y, gamma, ln, dt),
                             elems * (4 + 2 + 4 + 2)),
        "residual_ln.residual": (lambda: vp.residual_ln(x, y, gamma),
                                 lambda: vp.residual_ln_plain(x, y, gamma), elems * (4 + 2 + 4)),
        "silu_mul": (lambda: vp.silu_mul(h), lambda: vp.silu_mul_plain(h), hid * (2 + 2 + 2)),
    }
    report = {"device": torch.cuda.get_device_name(cuda_device)}
    with torch.inference_mode():
        for name, (kernel, plain, nbytes) in cases.items():
            k_ms, p_ms = _ms_per_call(kernel), _ms_per_call(plain)
            report[name] = {"kernel_us": k_ms * 1e3, "plain_us": p_ms * 1e3,
                            "device_us": _device_us_per_call(kernel),
                            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "mb": nbytes / 1e6}
    print(json.dumps({"vit_pointwise_times": report}))
    for name in cases:
        assert report[name]["kernel_us"] < report[name]["plain_us"], report
