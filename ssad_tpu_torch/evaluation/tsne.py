"""Exact t-SNE in PyTorch, on the device of its input.

The JAX package draws ``<subject>_tsne.png`` with scikit-learn's
``TSNE(n_components=2, random_state=seed, perplexity=p)``
(ssad_tpu/evaluation/visualization.py:114-135); the machines the port
runs on have no scikit-learn, so this module computes the same embedding
with scikit-learn's defaults and its optimiser:

* squared Euclidean input distances; per row a binary search for the
  Gaussian precision whose conditional distribution has entropy
  log(perplexity) (tolerance 1e-5, at most 100 steps); P symmetrised and
  normalised, floored at float64's machine epsilon;
* PCA initialisation (scikit-learn's default), rescaled so that the
  first coordinate has standard deviation 1e-4: the result depends on
  the input alone, so ``seed`` is kept only for the JAX ``plot_tsne``'s
  signature and does not change it;
* a Student-t kernel with one degree of freedom, the exact KL gradient
  (O(n²): scikit-learn's default is Barnes-Hut, an approximation of it);
* gradient descent with momentum and gains (+0.2 / ×0.8, at least 0.01),
  learning rate max(n / 12 / 4, 50): 250 steps with P exaggerated 12×
  at momentum 0.5, then up to 1000 in all at momentum 0.8, stopping where
  scikit-learn stops (every 50 steps: gradient norm ≤ 1e-7, or no
  better KL for 300 steps).

The result is held to scikit-learn's by trustworthiness on the CPU
(tests/test_torch_tsne.py), not by coordinates.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: float64's machine epsilon, scikit-learn's floor on P and Q
MACHINE_EPSILON = float(torch.finfo(torch.float64).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITERS = 1000
ITER_CHECK = 50
ITERS_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01


def default_perplexity(n: int) -> float:
    """The JAX package's choice for n points: min(30, max(5, n // 4))."""
    return float(min(30, max(5, n // 4)))


def _conditional_p(dist: torch.Tensor, perplexity: float, steps: int = 100,
                   tol: float = 1e-5) -> torch.Tensor:
    """Row-wise binary search for the precision β with entropy
    log(perplexity) (scikit-learn's ``_binary_search_perplexity``, every
    row at once) → conditional P, zero on the diagonal."""
    n = dist.shape[0]
    d = dist.double()
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    desired = math.log(perplexity)
    p = torch.zeros_like(d)
    for _ in range(steps):
        cand = torch.exp(-d * beta[:, None]) * off
        s = cand.sum(dim=1)
        s = torch.where(s == 0, torch.full_like(s, 1e-8), s)
        entropy = torch.log(s) + beta * (d * cand).sum(dim=1) / s
        # rows already within tolerance keep their P and β
        p = torch.where(done[:, None], p, cand / s[:, None])
        diff = entropy - desired
        now = done | (diff.abs() <= tol)
        up = ~now & (diff > 0)
        down = ~now & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        grow = torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2)
        shrink = torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2)
        beta = torch.where(up, grow, torch.where(down, shrink, beta))
        done = now
    return p


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Symmetric (n, n) P of the rows of ``x`` (float64)."""
    x = x.double()
    sq = (x * x).sum(dim=1)
    dist = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    dist.fill_diagonal_(0.0)
    cond = _conditional_p(dist.float(), perplexity)
    p = cond + cond.T
    p = p / torch.clamp(p.sum(), min=MACHINE_EPSILON)
    p = torch.clamp(p, min=MACHINE_EPSILON)
    p.fill_diagonal_(0.0)
    return p


def _pca_init(x: torch.Tensor) -> torch.Tensor:
    centred = x.double() - x.double().mean(dim=0)
    _, _, vh = torch.linalg.svd(centred, full_matrices=False)
    y = (centred @ vh[:2].T).float()
    return y / y[:, 0].std(unbiased=False) * 1e-4


def _kl_and_grad(p: torch.Tensor, y: torch.Tensor):
    """(KL(P‖Q), ∂KL/∂y) of the embedding ``y`` (n, 2) with one degree of
    freedom: Q ∝ 1 / (1 + ‖yᵢ − yⱼ‖²)."""
    sq = (y * y).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (y @ y.T), min=0.0)
    w = 1.0 / (1.0 + d2)
    w.fill_diagonal_(0.0)
    q = torch.clamp(w / w.sum(), min=MACHINE_EPSILON)
    kl = (p * torch.log(torch.clamp(p, min=MACHINE_EPSILON) / q)).sum()
    pq = (p - q) * w
    grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
    return kl, grad


def tsne(x: torch.Tensor, perplexity: Optional[float] = None,
         seed: int = 0) -> torch.Tensor:
    """(n, D) rows → (n, 2) float32 embedding, on ``x``'s device.  ``seed``
    is unused (PCA start; see the module docstring)."""
    n = x.shape[0]
    if n < 2:
        raise ValueError(f"t-SNE needs at least 2 points, got {n}")
    perplexity = default_perplexity(n) if perplexity is None else float(perplexity)
    p = joint_probabilities(x, perplexity)
    y = _pca_init(x).double()
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    it = 0
    for stage_end, momentum, patience, exaggeration in (
            (EXPLORATION_ITERS, 0.5, EXPLORATION_ITERS, EARLY_EXAGGERATION),
            (MAX_ITERS, 0.8, ITERS_WITHOUT_PROGRESS, 1.0)):
        pe = p * exaggeration
        best, best_iter = math.inf, it
        for i in range(it, stage_end):
            kl, grad = _kl_and_grad(pe, y)
            inc = update * grad < 0.0
            gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=MIN_GAIN)
            grad = grad * gains
            update = momentum * update - lr * grad
            y = y + update
            it = i
            if (i + 1) % ITER_CHECK == 0:
                error, grad_norm = float(kl), float(grad.norm())
                if error < best:
                    best, best_iter = error, i
                elif i - best_iter > patience:
                    break
                if grad_norm <= MIN_GRAD_NORM:
                    break
        it += 1
    return y.float()
