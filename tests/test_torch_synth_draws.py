"""The port's own draws (a seeded ``torch.Generator``) against the JAX
engine's draws and the reference-policy oracles of
tests/test_ref_distributions.py.

Chi-square on labels, colour modes, scar copies and polygon vertex
counts; two-sample KS on crop area, aspect and position, on polygon edge
coordinates and on the line walk's spacing.  The seeds are fixed, so the
outcome is deterministic; every p-value must be ≥ 1e-3.  The port's rank
arithmetic on the JAX engine's uniforms gives presample_indices' indices
(the walk's f32 recurrence, summed in another order, may truncate one rank
the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_synth import jax_draws
from scipy.stats import binom, chi2_contingency, chisquare, ks_2samp
from test_ref_distributions import ref_crop_geometry, ref_polygon_points, ref_walk

from ssad_tpu.data import synthetic as js
from ssad_tpu_torch.config import AugConfig
from ssad_tpu_torch.data import synthetic as syn

torch.set_num_threads(1)
P_MIN = 1e-3
N = 4000
SPEC = syn.SynthSpec(subject="bottle", imsize=(256, 256))


@pytest.fixture(scope="module")
def ours():
    return syn.draw(SPEC, N, torch.Generator().manual_seed(11), n_cut=3)


@pytest.fixture(scope="module")
def theirs():
    return jax_draws(SPEC, jax.random.split(jax.random.key(12), N), n_cut=3)


def _counts(t, k, offset=0):
    return np.bincount(t.numpy() - offset, minlength=k)[:k]


@pytest.mark.parametrize("field, k, offset, probs", [
    ("label", 4, 0, [0.25] * 4),
    ("color_mode", 3, 0, list(AugConfig().color_probs)),
    ("scar_copies", 4, 2, [0.25] * 4),
    ("jitter_order", 6, 0, [1 / 6] * 6),
    ("line_color", 3, 0, [1 / 3] * 3),
    ("cut_index", 3, 0, [1 / 3] * 3),
])
def test_categorical_draws_match_the_policy_and_jax(ours, theirs, field, k, offset, probs):
    obs = _counts(getattr(ours, field), k, offset)
    assert obs.sum() == N
    assert chisquare(obs, np.asarray(probs) * N).pvalue >= P_MIN
    table = np.stack([obs, _counts(getattr(theirs, field), k, offset)])
    assert chi2_contingency(table).pvalue >= P_MIN


def test_label_order_groups_the_samples_by_label(ours):
    assert sum(ours.label_counts) == N
    sorted_labels = ours.label[ours.label_order]
    assert (sorted_labels[1:] >= sorted_labels[:-1]).all()
    assert ours.label_counts == tuple(_counts(ours.label, 4).tolist())


@pytest.mark.parametrize("kind", ["patch", "scar"])
def test_crop_geometry_matches_the_reference_policy(theirs, kind):
    aug = AugConfig()
    area, aspect = ((aug.patch_area_ratio, aug.patch_aspect_ratio) if kind == "patch"
                    else (aug.scar_area_ratio, aug.scar_aspect_ratio))
    pw, ph, left, top = (t.numpy() for t in syn._crop_geometry(
        torch.Generator().manual_seed(13), N, area, aspect, (256, 256)))
    rng = np.random.default_rng(14)
    ref = np.array([ref_crop_geometry(rng, area, aspect, 256, 256) for _ in range(N)])
    assert ks_2samp(pw * ph, ref[:, 0] * ref[:, 1]).pvalue >= P_MIN  # area
    assert ks_2samp(pw / ph, ref[:, 0] / ref[:, 1]).pvalue >= P_MIN  # aspect
    assert ks_2samp(left, ref[:, 2]).pvalue >= P_MIN
    assert ks_2samp(top, ref[:, 3]).pvalue >= P_MIN
    # and against the JAX engine's draws of the same kind
    sel = (theirs.label == (1 if kind == "patch" else 2)).numpy()
    jw, jh = theirs.defect_w.numpy()[sel], theirs.defect_h.numpy()[sel]
    assert ks_2samp(pw * ph, jw * jh).pvalue >= P_MIN


def test_polygon_vertices_match_the_reference_policy():
    w, h = 41, 29
    verts, count = syn._polygon_vertices(torch.Generator().manual_seed(15),
                                         torch.full((N,), w), torch.full((N,), h))
    verts, count = verts.numpy(), count.numpy()
    expected = binom.pmf(np.arange(5), 4, 0.5) * N
    assert chisquare(np.bincount(count - 4, minlength=5)[:5], expected).pvalue >= P_MIN
    rng = np.random.default_rng(16)
    ref = np.array([p for _ in range(N) for p in ref_polygon_points(rng, w, h)], np.float64)
    v = verts[np.arange(8)[None, :] < count[:, None]]
    assert ks_2samp(v[v[:, 0] == 0][:, 1], ref[ref[:, 0] == 0][:, 1]).pvalue >= P_MIN
    assert ks_2samp(v[v[:, 1] == 0][:, 0], ref[ref[:, 1] == 0][:, 0]).pvalue >= P_MIN
    # the same polygon as the JAX helper from the same integers: closed,
    # simple, on the rectangle's border
    on_border = ((v[:, 0] == 0) | (v[:, 0] == w) | (v[:, 1] == 0) | (v[:, 1] == h))
    assert on_border.all()


def test_walk_spacing_matches_the_reference_policy():
    m, n, walks = 256 * 256, 60, 1200
    u = torch.rand((walks, n), generator=torch.Generator().manual_seed(17))
    ours = syn.walk_ranks(u, torch.tensor(m)).numpy()
    rng = np.random.default_rng(18)
    ref = np.stack([ref_walk(rng, m, n) for _ in range(walks)])
    assert (ours[:, 0] == 0).all() and (np.diff(ours, axis=1) >= 0).all()
    assert ks_2samp(np.diff(ours, axis=1).ravel(), np.diff(ref, axis=1).ravel()).pvalue >= P_MIN
    assert ks_2samp(ours[:, -1], ref[:, -1]).pvalue >= P_MIN
    assert ks_2samp(ours[:, 30], ref[:, 30]).pvalue >= P_MIN


def test_ranks_from_jax_uniforms_equal_presample_indices(theirs):
    """The helper's presampled uniforms, through the port's rank
    arithmetic, give the indices JAX's presample_indices gives for the
    same keys (bottle, image level, a 1000-pixel mask)."""
    count = 1000
    keys = jax.random.split(jax.random.key(12), N)
    idx = np.asarray(jax.jit(jax.vmap(
        lambda k: js.presample_indices(jax.random.fold_in(k, 0x5A11), jnp.int32(count),
                                       SPEC.line_points, SPEC.max_copies)))(keys))
    c = torch.tensor(count)
    poly = syn._uniform_rank(theirs.coord_u, c).numpy()
    scars = syn._uniform_rank(theirs.scar_u, c).clamp(max=count - 1).numpy()
    walk = syn.walk_ranks(theirs.walk_u, c).numpy()
    np.testing.assert_array_equal(poly, idx[:, 0])
    np.testing.assert_array_equal(scars, idx[:, 1:1 + SPEC.max_copies])
    off = np.abs(walk - idx[:, 1 + SPEC.max_copies:])
    assert off.max() <= 1 and (off == 0).mean() >= 0.999, ((off != 0).mean(), off.max())
