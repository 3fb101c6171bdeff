"""Seeded Lloyd KMeans in PyTorch.

Counterpart of pyannote_audio_tpu/ops/kmeans.py, and the port's stand-in
for the scikit-learn ``KMeans(n_init=3, random_state=42)`` that the JAX
package's clustering calls: kmeans++ seeding, 25 Lloyd iterations in which
an empty cluster keeps its centroid, the best of ``n_init`` runs by
inertia. The same code runs on the CPU and on a CUDA device: run ``i``
draws its uniform numbers from a CPU ``torch.Generator`` seeded with
``seed + i`` and turns them into picks on the device (inverse CDF of the
kmeans++ distribution), so both devices seed alike. It matches
scikit-learn's partition on well separated data, not its bits.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..utils.runtime import exact_float32


def _squared_distances(x: torch.Tensor, centroids: torch.Tensor
                       ) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) squared euclidean distances, clamped at 0."""
    return ((x * x).sum(dim=1, keepdim=True) - 2.0 * x @ centroids.T
            + (centroids * centroids).sum(dim=1)[None]).clamp_min_(0.0)


def _plusplus_init(x: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """kmeans++ seeding: each next centroid drawn with probability
    proportional to its squared distance from the nearest one so far."""
    n = x.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64).to(x.device)
    first = (u[0] * n).long().clamp_(max=n - 1)
    centroids = x[first].repeat(k, 1)
    for t in range(1, k):
        dmin = _squared_distances(x, centroids[:t]).min(dim=1).values
        cdf = torch.cumsum(dmin.double(), dim=0)
        idx = torch.searchsorted(cdf, (u[t] * cdf[-1])[None], right=True)
        centroids[t] = x[idx.clamp_(max=n - 1)[0]]
    return centroids


def _lloyd(x: torch.Tensor, k: int, iters: int,
           generator: torch.Generator):
    """One seeded run: (assignments (n,), inertia) on x's device."""
    centroids = _plusplus_init(x, k, generator)
    for _ in range(iters):
        assign = _squared_distances(x, centroids).argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = onehot.sum(dim=0)[:, None]
        centroids = torch.where(counts > 0,
                                (onehot.T @ x) / counts.clamp_min(1.0),
                                centroids)
    d2 = _squared_distances(x, centroids)
    return d2.argmin(dim=1), d2.min(dim=1).values.sum()


def kmeans(embeddings: np.ndarray, num_clusters: int, n_init: int = 3,
           iters: int = 25, seed: int = 42,
           device: Union[str, torch.device] = "cpu") -> np.ndarray:
    """Best-of-``n_init`` Lloyd KMeans of (n, d) embeddings on ``device``
    in float32 -> (n,) int64 cluster ids (an id may have no member)."""
    embeddings = np.asarray(embeddings)
    if not np.all(np.isfinite(embeddings)):
        raise ValueError("kmeans: input contains NaN or infinity")
    x = torch.as_tensor(embeddings, dtype=torch.float32).to(device)
    best, best_inertia = None, np.inf
    with exact_float32():
        for i in range(n_init):
            generator = torch.Generator().manual_seed(seed + i)
            assign, inertia = _lloyd(x, int(num_clusters), iters, generator)
            inertia = float(inertia)
            if inertia < best_inertia:
                best, best_inertia = assign, inertia
    return best.cpu().numpy()
