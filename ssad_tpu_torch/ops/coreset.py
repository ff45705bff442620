"""k-center-greedy coreset selection for normality embeddings.

Counterpart of ssad_tpu/ops/coreset.py:35-76.  Distils many patch
embeddings to a fixed-size bank that covers the normal manifold: the
first center is a seeded-random row, every next one the row farthest from
the centers so far (the greedy 2-approximation of the k-center
objective).  Rows are L2-normalised and the distance is the squared
chordal distance 2 − 2·cos, monotone in the k-NN scorer's cosine
distance.  ``argmax`` takes the first maximum, as ``jnp.argmax`` does.

The k-step loop is serial by nature.  It stays on the tensor's device:
the newest center is indexed by a device tensor and no step reads a value
back to the host, so on the card the k steps are queued without a sync
(each a (N, D) × (D,) product, a minimum and an argmax).

The first index comes from a CPU ``torch.Generator``; the JAX package
draws it with ``jax.random.randint``, so the same seed picks another
first row.  ``first`` hands one over (the tests give JAX's).
"""

from __future__ import annotations

from typing import Optional

import torch


def kcenter_greedy(embeddings: torch.Tensor, k: int,
                   generator: Optional[torch.Generator] = None,
                   first: Optional[int] = None) -> torch.Tensor:
    """Indices (k,) int64, on the embeddings' device, of a k-center-greedy
    coreset of the rows.  ``first`` fixes the first center; otherwise it
    is drawn from ``generator`` (a CPU generator; seed 0 when None)."""
    x = torch.as_tensor(embeddings).float()
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
    if first is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        first = int(torch.randint(0, n, (), generator=generator))
    # filled with the first index: a fill, where a scalar write would copy
    # from the host and wait for it
    selected = torch.full((k,), int(first), dtype=torch.long, device=x.device)
    min_d = torch.full((n,), float("inf"), device=x.device)
    for i in range(1, k):
        center = xn.index_select(0, selected[i - 1:i])[0]
        # squared chordal distance to the newest center: 2 - 2·cos
        torch.minimum(min_d, 2.0 - 2.0 * (xn @ center), out=min_d)
        # selected rows sit at distance 0, so argmax never re-picks one
        # while a row is uncovered
        selected[i] = torch.argmax(min_d)
    return selected


def coreset_select(embeddings: torch.Tensor, k: int,
                   generator: Optional[torch.Generator] = None,
                   first: Optional[int] = None) -> torch.Tensor:
    """The coreset rows themselves (k, D); the input as it is when it has
    ≤ k rows already."""
    emb = torch.as_tensor(embeddings)
    if emb.shape[0] <= k:
        return emb
    return emb.index_select(0, kcenter_greedy(emb, k, generator, first))
