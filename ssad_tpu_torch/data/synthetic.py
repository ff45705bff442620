"""The CutPaste pretext synthesizer (the 4-way pretext task), batched.

Counterpart of ssad_tpu/data/synthetic.py.  Labels (reference
datasets.py:215, :261-388):

    0 — good (colour jitter only)
    1 — polygon patch: a crop (or a flat colour) pasted under a random
        4-8-gon alpha mask
    2 — scar: a small crop rotated by ±45° and pasted 2-5 times
    3 — line: a smoothed polyline through the object mask

The work is split in two.  ``draw`` makes every random quantity of a
batch (``SynthDraws``) on the host from an explicit ``torch.Generator``,
by the reference's policies: a few hundred scalars a batch, uploaded
once.  ``synthesize`` is then deterministic: batched tensor ops over
(B, H, W, 3) on the images' device, no Python loop per sample and no
device → host read.  The labels are known on the host, so each defect
branch runs only on the samples that drew it (the JAX package evaluates
all four branches for every sample under ``lax.switch``).

The pixel work follows the JAX package's semantics and roundings: the
pipeline runs in bf16, the affine zoom and its 3-shear rotation round as
ops/image.py says, shear shifts are round() of f32 products, the Savitzky
-Golay operator is f32, and the reference's quirks stay (the container
clamp reads the canvas width for both axes; the forced-good threshold is
patch²/6; the rectangle mean divides by the full requested area).  Its
TPU workarounds (one-hot shift matmuls, one-hot shears and rank sorts,
the associative-scan walk) become gathers, a stable sort and a loop over
the walk's points.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import AugConfig, DataConfig
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops import rasterize

# Subject-specific pre-crops of patch mode (datasets.py:243-248), as
# (left, top, right, bottom) on the 256px canvas.
_DATA = DataConfig()

PATCH_MODE_PRECROPS = {
    "capsule": (0, 50, 255, 200),
    "screw": (25, 25, 230, 230),
}

#: black / white / silver (datasets.py:369)
LINE_COLORS = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (192 / 255.0,) * 3)


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """Static configuration of the synthesizer for one (subject, mode):
    every shape of a batch follows from it."""

    subject: str
    imsize: Tuple[int, int] = _DATA.imsize
    patch_localization: bool = _DATA.patch_localization
    patch_size: int = _DATA.patch_size
    aug: AugConfig = dataclasses.field(default_factory=AugConfig)

    @property
    def is_texture(self) -> bool:
        return constants.is_texture(self.subject)

    @property
    def is_non_fixed(self) -> bool:
        return constants.is_non_fixed_object(self.subject)

    @property
    def precrop(self) -> Optional[Tuple[int, int, int, int]]:
        if self.patch_localization:
            return PATCH_MODE_PRECROPS.get(self.subject)
        return None

    @property
    def precrop_hw(self) -> Tuple[int, int]:
        """The canvas after the pre-crop (slicing semantics: clipped to the
        image)."""
        h, w = self.imsize
        if self.precrop is None:
            return h, w
        left, top, right, bottom = self.precrop
        return min(bottom, h) - min(top, h), min(right, w) - min(left, w)

    @property
    def canvas(self) -> Tuple[int, int]:
        if self.patch_localization:
            return (self.patch_size, self.patch_size)
        return tuple(self.imsize)

    @property
    def patch_area_ratio(self) -> Tuple[float, float]:
        return (self.aug.patch_area_ratio_patchmode if self.patch_localization
                else self.aug.patch_area_ratio)

    @property
    def scar_area_ratio(self) -> Tuple[float, float]:
        return (self.aug.scar_area_ratio_patchmode if self.patch_localization
                else self.aug.scar_area_ratio)

    @property
    def container_scale_patch(self) -> float:
        return 1.0 if self.patch_localization else self.aug.container_scale_patch

    @property
    def container_scale_scar(self) -> float:
        return 1.0 if self.patch_localization else self.aug.container_scale_scar

    @property
    def line_points(self) -> int:
        return (self.aug.line_points_patch if self.patch_localization
                else self.aug.line_points_image)

    @property
    def line_width(self) -> float:
        return float(self.aug.line_width_patch if self.patch_localization
                     else self.aug.line_width_image)

    @property
    def max_copies(self) -> int:
        return self.aug.scar_copies[1]

    def _tile(self, area_hi: float, aspect_hi: float, rotated: bool) -> int:
        """Static tile side covering the largest defect crop (rotated:
        PIL's expand=True bounding box)."""
        h, w = self.canvas
        side = math.sqrt(area_hi * h * w * aspect_hi)
        if rotated:
            side *= math.sqrt(2.0)
        return int(math.ceil((side + 2) / 8.0) * 8)

    @staticmethod
    def _aspect_extreme(ranges) -> float:
        """Largest side stretch over every endpoint of the aspect intervals
        (√aspect widens, √(1/aspect) heightens)."""
        vals = [v for r in ranges for v in r]
        return max(max(vals), 1.0 / min(vals))

    @property
    def poly_tile(self) -> int:
        return self._tile(self.patch_area_ratio[1],
                          self._aspect_extreme(self.aug.patch_aspect_ratio), False)

    @property
    def scar_tile(self) -> int:
        return self._tile(self.scar_area_ratio[1],
                          self._aspect_extreme(self.aug.scar_aspect_ratio), True)


# --- the draws ----------------------------------------------------------------


@dataclasses.dataclass
class SynthDraws:
    """Every random quantity of one batch, one row per sample.

    Fields a sample's branch does not read are drawn all the same (so a
    batch's draws have fixed shapes).  ``label_order`` (the samples sorted
    by label, stable) and ``label_counts`` (host ints) let ``synthesize``
    run each branch on its own samples without reading the device; they
    are derived from ``label`` when the draws are made on the host."""

    label: torch.Tensor  # (B,) int64 in 0..3 (datasets.py:215)
    affine_angle: torch.Tensor  # (B,) f32 degrees, fixed-pose image level
    affine_scale: torch.Tensor  # (B,) f32
    cut_index: torch.Tensor  # (B,) int64 into the cut pool (textures)
    crop_left: torch.Tensor  # (B,) int64: patch-mode crop of the canvas
    crop_top: torch.Tensor
    cut_left: torch.Tensor  # (B,) int64: its own crop of the cut source
    cut_top: torch.Tensor
    defect_w: torch.Tensor  # (B,) int64: crop geometry of label 1 or 2
    defect_h: torch.Tensor
    src_left: torch.Tensor
    src_top: torch.Tensor
    color_mode: torch.Tensor  # (B,) int64: 0 crop, 1 its mean colour, 2 random
    flat_rgb: torch.Tensor  # (B, 3) int64 in 0..255 (mode 2)
    brightness: torch.Tensor  # (B,) f32: product of the two retouch factors
    poly_vertices: torch.Tensor  # (B, 8, 2) f32, patch-local (x, y)
    poly_count: torch.Tensor  # (B,) int64 in 4..8
    scar_angle: torch.Tensor  # (B,) int64 degrees
    scar_copies: torch.Tensor  # (B,) int64
    coord_u: torch.Tensor  # (B,) f32: uniform behind the polygon's mask coordinate
    scar_u: torch.Tensor  # (B, max_copies) f32: the scars' coordinates
    walk_u: torch.Tensor  # (B, line_points) f32: the line's walk through the mask
    line_left: torch.Tensor  # (B,) bool: points sorted by x (grown from the left)
    line_color: torch.Tensor  # (B,) int64 into LINE_COLORS
    line_segment: torch.Tensor  # (B,) int64: which tenth of the walk (image level)
    jitter: torch.Tensor  # (B, 3) f32 brightness, contrast, saturation factors
    jitter_order: torch.Tensor  # (B,) int64 into ops.image.JITTER_ORDERS
    label_order: Optional[torch.Tensor] = None
    label_counts: Optional[Tuple[int, int, int, int]] = None

    def __post_init__(self):
        if self.label_order is None:
            label = self.label.cpu()
            self.label_order = torch.argsort(label, stable=True)
            counts = torch.bincount(label, minlength=constants.NUM_PRETEXT_CLASSES)
            self.label_counts = tuple(int(c) for c in counts)

    def to(self, device) -> "SynthDraws":
        """A copy with every tensor on ``device`` (the batch's one upload)."""
        return SynthDraws(**{
            f.name: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(self) for v in (getattr(self, f.name),)
        })


def randint_incl(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """random.randint semantics (inclusive bounds) from uniforms in [0, 1),
    with the JAX package's f32 arithmetic: lo + floor(u·(hi − lo + 1))."""
    lo = torch.as_tensor(lo, dtype=torch.int64, device=u.device)
    hi = torch.maximum(torch.as_tensor(hi, dtype=torch.int64, device=u.device), lo)
    return lo + torch.floor(u * (hi - lo + 1).float()).long()


def _uniform(gen, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def _crop_geometry(gen, n: int, area_ratio, aspect_ratio, cut_hw):
    """Crop size and position (reference generate_patch,
    dataset_generator.py:164-210): (pw, ph, src_left, src_top)."""
    cut_h, cut_w = cut_hw
    area = _uniform(gen, n, *area_ratio) * float(cut_h * cut_w)
    a1 = _uniform(gen, n, *aspect_ratio[0])
    a2 = _uniform(gen, n, *aspect_ratio[1])
    aspect = torch.where(torch.rand(n, generator=gen) < 0.5, a1, a2)
    pw = torch.sqrt(area * aspect).long().clamp(min=2)
    ph = torch.sqrt(area / aspect).long().clamp(min=2)
    left = randint_incl(torch.rand(n, generator=gen), 0, (cut_w - pw).clamp(min=1))
    top = randint_incl(torch.rand(n, generator=gen), 0, (cut_h - ph).clamp(min=1))
    return pw, ph, left, top


def _polygon_vertices(gen, pw: torch.Tensor, ph: torch.Tensor):
    """A random 4-8-gon on the border of each (pw, ph) rectangle (reference
    rect2poly(sides=8), dataset_generator.py:63-98): each side gives 1 or 2
    points, a two-point side in the reference's half-range order, so the
    walk stays a simple polygon.  → ((n, 8, 2) f32, (n,) count)."""
    n = pw.shape[0]
    w, h = pw, ph
    hw, hh = w // 2, h // 2
    two = torch.rand((n, 4), generator=gen) < 0.5

    def r(lo, hi):
        return randint_incl(torch.rand(n, generator=gen), lo, hi).float()

    zero, wf, hf = torch.zeros(n), w.float(), h.float()
    singles = (torch.stack([zero, r(1, h)], -1), torch.stack([r(1, w), zero], -1),
               torch.stack([wf, r(1, h)], -1), torch.stack([r(1, w), hf], -1))
    firsts = (torch.stack([zero, r(hh + 1, h)], -1), torch.stack([r(1, hw), zero], -1),
              torch.stack([wf, r(1, hh)], -1), torch.stack([r(hw + 1, w), hf], -1))
    seconds = (torch.stack([zero, r(1, hh)], -1), torch.stack([r(hw + 1, w), zero], -1),
               torch.stack([wf, r(hh + 1, h)], -1), torch.stack([r(1, hw), hf], -1))
    verts = torch.zeros((n, 8, 2))
    row = torch.arange(8)
    off = torch.zeros(n, dtype=torch.int64)
    for side in range(4):
        p1 = torch.where(two[:, side, None], firsts[side], singles[side])
        verts = torch.where((row == off[:, None])[..., None], p1[:, None, :], verts)
        second = (row == off[:, None] + 1) & two[:, side, None]
        verts = torch.where(second[..., None], seconds[side][:, None, :], verts)
        off = off + 1 + two[:, side].long()
    return verts, off


def draw(spec: SynthSpec, n: int, generator: torch.Generator, n_cut: int = 1) -> SynthDraws:
    """The draws of an ``n``-sample batch, on the host, from ``generator``
    (a CPU ``torch.Generator``), by the reference's policies.  ``n_cut``:
    the cut pool's size (textures)."""
    gen, aug = generator, spec.aug
    label = randint_incl(torch.rand(n, generator=gen), 0, 3)

    h, w = spec.imsize
    p = spec.patch_size
    ch, cw = spec.precrop_hw
    patch = spec.patch_localization
    cut_hw = spec.canvas  # the cut source is cropped to the patch in patch mode
    poly = _crop_geometry(gen, n, spec.patch_area_ratio, aug.patch_aspect_ratio, cut_hw)
    scar = _crop_geometry(gen, n, spec.scar_area_ratio, aug.scar_aspect_ratio, cut_hw)
    is_scar = label == 2
    pw, ph, src_left, src_top = (torch.where(is_scar, s, q) for q, s in zip(poly, scar))

    u = torch.rand(n, generator=gen)
    color_mode = torch.where(u < aug.color_probs[0], 0,
                             torch.where(u < aug.color_probs[0] + aug.color_probs[1], 1, 2))
    low = _uniform(gen, n, *aug.brightness_low)
    high = _uniform(gen, n, *aug.brightness_high)
    f1 = torch.where(torch.rand(n, generator=gen) < 0.5, low, high)
    f2 = torch.where(torch.rand(n, generator=gen) < 0.5, low, high)
    verts, count = _polygon_vertices(gen, pw, ph)

    def ints(lo, hi, shape=(n,)):
        return randint_incl(torch.rand(shape, generator=gen), lo, hi)

    v = aug.jitter_offset
    return SynthDraws(
        label=label,
        affine_angle=_uniform(gen, n, -aug.affine_degrees, aug.affine_degrees),
        affine_scale=_uniform(gen, n, *aug.affine_scale),
        cut_index=ints(0, max(n_cut - 1, 0)),
        crop_left=ints(0, cw - p) if patch else torch.zeros(n, dtype=torch.int64),
        crop_top=ints(0, ch - p) if patch else torch.zeros(n, dtype=torch.int64),
        cut_left=ints(0, w - p) if patch else torch.zeros(n, dtype=torch.int64),
        cut_top=ints(0, h - p) if patch else torch.zeros(n, dtype=torch.int64),
        defect_w=pw, defect_h=ph, src_left=src_left, src_top=src_top,
        color_mode=color_mode,
        flat_rgb=ints(0, 255, (n, 3)),
        brightness=f1 * f2,
        poly_vertices=verts, poly_count=count,
        scar_angle=ints(*aug.scar_angle_range),
        scar_copies=ints(*aug.scar_copies),
        coord_u=torch.rand(n, generator=gen),
        scar_u=torch.rand((n, spec.max_copies), generator=gen),
        walk_u=torch.rand((n, spec.line_points), generator=gen),
        line_left=torch.rand(n, generator=gen) < 0.5,
        line_color=ints(0, len(LINE_COLORS) - 1),
        line_segment=ints(0, aug.line_splits - 1),
        jitter=_uniform(gen, (n, 3), max(0.0, 1 - v), 1 + v),
        jitter_order=torch.randint(0, len(im.JITTER_ORDERS), (n,), generator=gen),
    )


# --- mask coordinates -----------------------------------------------------------


def walk_ranks(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(..., n) monotone ranks into a mask's row-major coordinate list, by
    the reference's progressive recurrence (datasets.py:362-368): index_0
    = 0, index_i = randint(index_{i−1}, floor(M·i/n)), in continuous form
    x_i = (1 − u_i)·x_{i−1} + u_i·b_i with b_i = floor(M·i/n), in f32.
    ``count`` (M): a scalar or one per row of ``u``."""
    n = u.shape[-1]
    count = torch.as_tensor(count, device=u.device)
    m = count.clamp(min=1).float()[..., None]
    b = torch.floor(m * torch.arange(n, dtype=torch.float32, device=u.device) / n)
    a = 1.0 - u
    c = u * b
    xs = [c[..., 0]]
    for i in range(1, n):
        xs.append(torch.addcmul(c[..., i], a[..., i], xs[-1]))
    ranks = torch.stack(xs, dim=-1).long()
    return torch.minimum(ranks.clamp(min=0), (count - 1).clamp(min=0)[..., None])


def _uniform_rank(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """floor(u · max(M, 1)) in f32: a uniform index into M coordinates."""
    return torch.floor(u * count.clamp(min=1).float()).long()


class _PackedCoords:
    """Image level: ranks index a packed (row-major, (x, y)) coordinate
    list, shared by the batch or one per image; a rank past the list reads
    its last row (the padding repeats the last coordinate)."""

    def __init__(self, coords: torch.Tensor, counts: torch.Tensor):
        self.coords, self.counts = coords, counts

    def select(self, rows: torch.Tensor) -> "_PackedCoords":
        per_image = self.coords.ndim == 3
        return _PackedCoords(self.coords.index_select(0, rows) if per_image else self.coords,
                             self.counts.index_select(0, rows) if per_image else self.counts)

    def count(self) -> torch.Tensor:
        return self.counts

    def lookup(self, ranks: torch.Tensor) -> torch.Tensor:
        """(G, K) ranks → (G, K, 2) int64 (x, y)."""
        ranks = ranks.clamp(0, self.coords.shape[-2] - 1)
        if self.coords.ndim == 2:
            return self.coords[ranks].long()
        rows = torch.arange(ranks.shape[0], device=ranks.device)[:, None]
        return self.coords[rows, ranks].long()


class _CdfCoords:
    """Patch mode: ranks index the set pixels of each cropped mask, through
    its inclusive prefix sum (the r-th set pixel is the number of prefix
    sums ≤ r, clipped to the canvas)."""

    def __init__(self, cdf: torch.Tensor, width: int):
        self.cdf, self.width = cdf, width

    def select(self, rows: torch.Tensor) -> "_CdfCoords":
        return _CdfCoords(self.cdf.index_select(0, rows), self.width)

    def count(self) -> torch.Tensor:
        return self.cdf[:, -1]

    def lookup(self, ranks: torch.Tensor) -> torch.Tensor:
        idx = torch.searchsorted(self.cdf, ranks, right=True).clamp(max=self.cdf.shape[1] - 1)
        return torch.stack([idx % self.width, idx // self.width], dim=-1)


# --- pixel moves ------------------------------------------------------------------


def _window(src: torch.Tensor, left: torch.Tensor, top: torch.Tensor,
            out_h: int, out_w: int) -> torch.Tensor:
    """out[b, i, k] = src[b, top[b] + i, left[b] + k], zero outside src:
    a crop (PIL pads an out-of-bounds crop with black) or, with negated
    offsets, a placement on a larger canvas.  src: (B, H, W, C)."""
    b, h, w, _ = src.shape
    rows = top[:, None] + torch.arange(out_h, device=src.device)
    cols = left[:, None] + torch.arange(out_w, device=src.device)
    ok = ((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :]
    bi = torch.arange(b, device=src.device)[:, None, None]
    out = src[bi, rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(ok[..., None], out, torch.zeros((), dtype=src.dtype, device=src.device))


def _composite(x: torch.Tensor, content: torch.Tensor, alpha: torch.Tensor,
               paste_l: torch.Tensor, paste_t: torch.Tensor) -> torch.Tensor:
    """Paste (G, T, T, 3) tiles at (paste_l, paste_t) where their (G, T, T)
    alpha is set (PIL paste with a mask: a later paste wins)."""
    rgba = torch.cat([content, alpha[..., None].to(content.dtype)], dim=-1)
    placed = _window(rgba, -paste_l, -paste_t, x.shape[1], x.shape[2])
    return torch.where(placed[..., 3:4] > 0, placed[..., :3], x)


def _container_clamp(canvas_hw, patch_w, patch_h, cx, cy, scale: float):
    """Clamp a paste box into the central container (reference
    check_valid_coordinates_by_container, dataset_generator.py:104-144:
    it reads imsize[0], PIL's width, for both axes; canvas_hw is (H, W),
    so canvas_hw[1]).  The container's bounds truncate after the
    subtraction (Container, dataset_generator.py:15-24)."""
    center = canvas_hw[1] // 2
    low = int(center - center / scale)
    high = int(center + center / scale)
    paste_l = cx - patch_w // 2
    paste_t = cy - patch_h // 2
    paste_l = torch.where(cx + patch_w // 2 > high, high - patch_w, paste_l)
    paste_t = torch.where(cy + patch_h // 2 > high, high - patch_h, paste_t)
    return paste_l.clamp(min=low), paste_t.clamp(min=low)


def _rect_mean(tile: torch.Tensor, rect: torch.Tensor, pw, ph) -> torch.Tensor:
    """Mean RGB of a crop region held in a tile, divided by the FULL w·h
    (the reference means a PIL crop whose out-of-bounds part is black,
    dataset_generator.py:206), floored to 1/255 as the reference's int
    colour."""
    total = (tile.float() * rect[..., None]).sum(dim=(1, 2))
    avg = total / (pw * ph).clamp(min=1).float()[:, None]
    return torch.floor(avg * 255.0) / 255.0


def _colorize(tile, rect, d, x_mean, threshold: float):
    """(colour mode, flat colour (G, 3) f32, brightness factor (G,)) of a
    crop (datasets.py:267-299, :311-333): the retouch applies when the
    defect's mean colour is nearly collinear with the canvas's."""
    avg = _rect_mean(tile, rect, d.defect_w, d.defect_h)
    rand = d.flat_rgb.float() / 255.0
    t = d.color_mode
    flat = torch.where((t == 1)[:, None], avg, rand)
    patch_mean = torch.where((t == 0)[:, None], avg, flat)
    similar = im.color_cosine_similarity(x_mean, patch_mean) > threshold
    bright = torch.where(similar, d.brightness, torch.ones_like(d.brightness))
    return t, flat, bright


def _paint(tile, t, flat, bright):
    """Crop pixels or a flat colour, brightness-retouched, in bf16."""
    content = torch.where((t == 0)[:, None, None, None], tile,
                          flat.to(tile.dtype)[:, None, None, :])
    return torch.clamp(content * bright.to(tile.dtype)[:, None, None, None], 0.0, 1.0)


def _rotate_tile(rgba: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate centred (G, T, T, C) tiles by theta (radians, clockwise in
    array coordinates) with the 3-shear decomposition, integer shifts:
    nearest-neighbour quality, like PIL's rotate."""
    t = rgba.shape[1]
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    lines = torch.arange(t, dtype=torch.float32, device=rgba.device) - (t - 1) / 2.0
    s_col = torch.round(a[:, None] * lines).long()
    s_row = torch.round(b[:, None] * lines).long()
    out = im.shear_lines(rgba, s_col, axis=2)
    out = im.shear_lines(out, s_row, axis=1)
    return im.shear_lines(out, s_col, axis=2)


# --- defect branches ---------------------------------------------------------------


class _Rows:
    """The draws of one label's samples: each field gathered on use."""

    def __init__(self, draws: SynthDraws, rows: torch.Tensor):
        self._draws, self._rows = draws, rows

    def __getattr__(self, name: str) -> torch.Tensor:
        return getattr(self._draws, name).index_select(0, self._rows)


def _paste_polygon_patch(spec: SynthSpec, x, x_mean, cut, d: _Rows, cs):
    """Label 1 (datasets.py:267-308)."""
    tile_n = spec.poly_tile
    pw, ph = d.defect_w, d.defect_h
    tile = _window(cut, d.src_left, d.src_top, tile_n, tile_n)
    ar = torch.arange(tile_n, device=x.device)
    rect = (ar[None, None, :] < pw[:, None, None]) & (ar[None, :, None] < ph[:, None, None])
    t, flat, bright = _colorize(tile, rect, d, x_mean, spec.aug.similarity_threshold)
    c = cs.lookup(_uniform_rank(d.coord_u, cs.count())[:, None])[:, 0]
    paste_l, paste_t = _container_clamp(spec.canvas, pw, ph, c[:, 0], c[:, 1],
                                        spec.container_scale_patch)
    content = _paint(tile, t, flat, bright)
    poly = rasterize.polygon_mask(d.poly_vertices, d.poly_count, (tile_n, tile_n)) > 0
    return _composite(x, content, poly & rect, paste_l, paste_t)


def _paste_scar(spec: SynthSpec, x, x_mean, cut, d: _Rows, cs):
    """Label 2: one crop rotated by ±45° and pasted 2-5 times
    (datasets.py:309-355)."""
    tile_n = spec.scar_tile
    pw, ph = d.defect_w, d.defect_h
    # the un-rotated scar centred in the tile, with a centred rect alpha
    x0, y0 = (tile_n - pw) // 2, (tile_n - ph) // 2
    tile = _window(cut, d.src_left - x0, d.src_top - y0, tile_n, tile_n)
    ar = torch.arange(tile_n, device=x.device)
    cols, rows = ar[None, None, :], ar[None, :, None]
    rect = ((cols >= x0[:, None, None]) & (cols < (x0 + pw)[:, None, None])
            & (rows >= y0[:, None, None]) & (rows < (y0 + ph)[:, None, None]))
    t, flat, bright = _colorize(tile, rect, d, x_mean, spec.aug.similarity_threshold)
    content = _paint(tile, t, flat, bright)
    theta = d.scar_angle.float() * (math.pi / 180.0)
    rgba = _rotate_tile(torch.cat([content, rect[..., None].to(content.dtype)], dim=-1), theta)
    content, alpha = rgba[..., :3], rgba[..., 3] > 0.5
    # PIL rotate(expand=True)'s bounding box
    cos_a, sin_a = torch.abs(torch.cos(theta)), torch.abs(torch.sin(theta))
    pwf, phf = pw.float(), ph.float()
    exp_w = torch.ceil(pwf * cos_a + phf * sin_a).long()
    exp_h = torch.ceil(pwf * sin_a + phf * cos_a).long()
    c = cs.lookup(_uniform_rank(d.scar_u, cs.count()[..., None]))
    copies = d.scar_copies
    for i in range(spec.max_copies):  # every copy pastes the same rotated scar (:344)
        paste_l, paste_t = _container_clamp(spec.canvas, exp_w, exp_h, c[:, i, 0], c[:, i, 1],
                                            spec.container_scale_scar)
        # the tile's centre on the expanded box's centre
        off_l = paste_l + torch.div(exp_w - tile_n, 2, rounding_mode="floor")
        off_t = paste_t + torch.div(exp_h - tile_n, 2, rounding_mode="floor")
        x = _composite(x, content, alpha & (i < copies)[:, None, None], off_l, off_t)
    return x


def _draw_line(spec: SynthSpec, x, d: _Rows, cs, savgol, colors):
    """Label 3: a smoothed polyline through the object mask
    (datasets.py:357-388)."""
    n = spec.line_points
    pts = cs.lookup(walk_ranks(d.walk_u, cs.count())).float()
    # sorted by x when grown from the left (datasets.py:371-372)
    order = torch.argsort(pts[..., 0], dim=1, stable=True)
    by_x = torch.gather(pts, 1, order[..., None].expand(-1, -1, 2))
    pts = torch.where(d.line_left[:, None, None], by_x, pts)
    pts = rasterize.smooth_polyline(pts, savgol)
    n_active = n
    if not spec.patch_localization:
        # one of line_splits runs of n // line_splits points (datasets.py:374-377)
        seg = n // spec.aug.line_splits
        idx = (d.line_segment * seg)[:, None] + torch.arange(seg, device=x.device)
        pts = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 2))
        n_active = seg
    color = colors.index_select(0, d.line_color)
    lmask = rasterize.polyline_mask(pts, n_active, spec.line_width, spec.canvas)
    return torch.where(lmask[..., None] > 0, color[:, None, None, :], x)


@functools.lru_cache(maxsize=32)
def _device_constants(n_walk: int, device: torch.device):
    """(Savitzky–Golay operator, line colours in bf16) on ``device``, made
    once, so that a batch copies nothing from the host."""
    savgol = torch.from_numpy(rasterize.savgol_matrix(n_walk, 10, 2)).to(device)
    colors = torch.from_numpy(np.asarray(LINE_COLORS, np.float32)).to(device, torch.bfloat16)
    return savgol, colors


# --- the synthesizer --------------------------------------------------------------


def synthesize(spec: SynthSpec, draws: SynthDraws, images: torch.Tensor,
               cut_pool: torch.Tensor, masks: torch.Tensor, coords: torch.Tensor,
               counts: torch.Tensor):
    """One pretext batch from given draws → (x, y, original).

    * images: (B, H, W, 3) f32 in [0, 1], the subject's train images;
    * cut_pool: (K, H, W, 3), the first image of every category: the cut
      sources of a texture (datasets.py:189-193, :225-228);
    * masks: (H, W) float {0, 1} object mask shared by the batch, or
      (B, H, W) one per image (NON_FIXED_OBJECTS at image level,
      datasets.py:232-235); all ones for a texture;
    * coords / counts: the packed mask coordinates, (M, 2) and a scalar or
      (B, M, 2) and (B,) with the masks; unread in patch mode, where the
      coordinates come from the cropped mask on the device.

    Everything on one device, the draws too (``SynthDraws.to``).  Returns
    x (B, h, w, 3) f32 ImageNet-normalised, y (B,) int64 labels, and the
    images.  Image level needs packed coordinates: ``prepare_pretext_data``
    in patch mode leaves 1-row placeholders.
    """
    if not spec.patch_localization and coords.shape[-2] == 1:
        raise ValueError(
            "image-level synthesis received 1-row placeholder coordinates: this "
            "PretextData was prepared with patch_localization=True; re-prepare it "
            "for image-level use"
        )
    dev = images.device
    b = images.shape[0]
    bf16 = torch.bfloat16
    aug = spec.aug
    x = images.to(bf16)  # the pipeline runs in bf16, as the JAX package's
    if not spec.patch_localization and not spec.is_non_fixed:
        x = im.random_affine(x, draws.affine_angle, draws.affine_scale, aug.affine_degrees)
    if spec.is_texture:
        cut = cut_pool.index_select(0, draws.cut_index).to(bf16)
    else:  # the un-affined original (datasets.py:228)
        cut = images.to(bf16)

    forced = None
    if spec.patch_localization:
        p = spec.patch_size
        if spec.precrop is not None:
            left, top, right, bottom = spec.precrop
            x = x[:, top:bottom, left:right]
            masks = masks[..., top:bottom, left:right]
        # a patch_size crop of canvas and mask, an independent one of the
        # cut source (datasets.py:249-253)
        x = _window(x, draws.crop_left, draws.crop_top, p, p)
        m = masks.expand(b, *masks.shape[-2:]) if masks.ndim == 2 else masks
        m = _window(m[..., None], draws.crop_left, draws.crop_top, p, p)[..., 0]
        cut = _window(cut, draws.cut_left, draws.cut_top, p, p)
        mask_bin = m > 0.5
        # too little object in the crop → 'good' (datasets.py:258-259); the
        # reference counts each pixel of an RGB mask 3× against patch²/2
        forced = 3.0 * mask_bin.sum(dim=(1, 2)).float() < (p * p) / 2.0
        cs = _CdfCoords(torch.cumsum(mask_bin.reshape(b, -1), dim=1), p)
    else:
        cs = _PackedCoords(coords, counts)

    x_mean = im.mean_color(x)
    savgol, colors = _device_constants(spec.line_points, dev)
    out = x.clone()
    start = 0
    for label, n in enumerate(draws.label_counts):
        rows = draws.label_order[start:start + n]
        start += n
        if label == 0 or n == 0:
            continue
        d, sub = _Rows(draws, rows), cs.select(rows)
        xg = x.index_select(0, rows)
        if label == 3:
            xg = _draw_line(spec, xg, d, sub, savgol, colors)
        else:
            branch = _paste_polygon_patch if label == 1 else _paste_scar
            xg = branch(spec, xg, x_mean.index_select(0, rows), cut.index_select(0, rows), d, sub)
        out.index_copy_(0, rows, xg)

    y = draws.label
    if forced is not None:
        out = torch.where(forced[:, None, None, None], x, out)
        y = torch.where(forced, torch.zeros_like(y), y)
    # the final jitter and ImageNet normalisation (datasets.py:391, :430-433)
    out = im.color_jitter(out, draws.jitter, draws.jitter_order)
    return im.normalize_imagenet(out).float(), y, images
