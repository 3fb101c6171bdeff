"""Agglomerative (centroid-linkage) clustering on the device.

Counterpart of pyannote_audio_tpu/ops/ahc.py: the centroid-linkage merge
sequence of (N, D) embeddings, its cut at a distance threshold, and its
conversion to scipy's linkage matrix. The JAX package recomputes the
whole (N, N) distance matrix at each of the N - 1 merges (2 N^2 D
operations a step). Here the squared-distance matrix stays on the device
and each merge updates only the merged slot's row and column from its new
centroid (O(N D)), masks the retired slot, and picks the next pair with
one argmin over the matrix; indices stay tensors, so the loop issues no
host sync, and on a CUDA device one step is captured as a CUDA graph and
replayed. Distances are float32 with TF32 off (a TF32 product moves
heights by about 1e-3 and reorders near-tied merges). The merges are the
same as the JAX package's and scipy's up to near ties; the cut and the
linkage matrix are host numpy, as there.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..utils.runtime import exact_float32

_INF = 1e30


def _merge_step(d2: torch.Tensor, centroids: torch.Tensor,
                sizes: torch.Tensor, alive: torch.Tensor,
                merges: torch.Tensor, heights: torch.Tensor,
                t: torch.Tensor) -> None:
    """Merge step ``t`` (a 0-d tensor, incremented here) of
    ``centroid_linkage``, in place on its state: every index stays a
    tensor, so the step has fixed shapes and no host sync."""
    n = d2.shape[0]
    flat = torch.argmin(d2).view(1)
    a, b = flat // n, flat % n
    i, j = torch.minimum(a, b), torch.maximum(a, b)
    heights.index_copy_(0, t, torch.sqrt(d2.view(-1).index_select(0, flat)))
    merges.index_copy_(0, t, torch.cat([i, j])[None])
    si, sj = sizes.index_select(0, i), sizes.index_select(0, j)
    merged = (centroids.index_select(0, i) * si[:, None]
              + centroids.index_select(0, j) * sj[:, None]) / (si + sj)
    centroids.index_copy_(0, i, merged)
    sizes.index_copy_(0, i, si + sj)
    alive.index_fill_(0, j, False)
    # the merged slot's distances to every live slot, from its new
    # centroid; retired slots and the diagonal stay at +inf
    row = ((centroids - merged) ** 2).sum(dim=1)
    row = torch.where(alive, row, _INF).index_fill_(0, i, _INF)
    d2.index_copy_(0, i, row[None])
    d2.index_copy_(1, i, row[:, None])
    d2.index_fill_(0, j, _INF)
    d2.index_fill_(1, j, _INF)
    t.add_(1)


@torch.inference_mode()
def centroid_linkage(embeddings: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid-linkage merge sequence of (N, D) embeddings.

    Returns ``merges`` (N - 1, 2) int64, the slots merged at each step
    (into ``merges[t, 0]``; ``merges[t, 1]`` is retired), and ``heights``
    (N - 1,) float32, the euclidean centroid distance of each merge, both
    on the embeddings' device. Ties go to the smallest flat index of the
    upper pair, as in the JAX package. On a CUDA device the first step
    runs eagerly and the others replay it as a CUDA graph (a step is
    about 30 small kernels, whose launches would bound it).
    """
    x = embeddings.to(torch.float32)
    n = x.shape[0]
    device = x.device
    with exact_float32():
        sq = (x * x).sum(dim=1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T),
                         min=0.0)
    d2.fill_diagonal_(_INF)
    state = (d2, x.clone(), torch.ones(n, device=device),
             torch.ones(n, dtype=torch.bool, device=device),
             torch.empty((max(n - 1, 0), 2), dtype=torch.int64,
                         device=device),
             torch.empty(max(n - 1, 0), device=device),
             torch.zeros(1, dtype=torch.int64, device=device))
    if device.type != "cuda" or n < 3:
        for _ in range(n - 1):
            _merge_step(*state)
        return state[4], state[5]
    # the first step runs eagerly (the warm-up that capture wants), the
    # second is captured on a side stream and replayed for the others;
    # capture_begin rather than torch.cuda.graph, which would synchronize
    # the device and empty the allocator's cache. The graph owns its
    # intermediates, so the stream is waited for before it goes
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        _merge_step(*state)
        graph.capture_begin(capture_error_mode="thread_local")
        _merge_step(*state)
        graph.capture_end()
        for _ in range(n - 2):
            graph.replay()
    stream.synchronize()
    return state[4], state[5]


def fcluster_by_distance(merges: np.ndarray, heights: np.ndarray,
                         num_leaves: int, threshold: float) -> np.ndarray:
    """Cut the merge sequence at ``threshold`` -> 0-indexed cluster ids.

    The equivalent of scipy's ``fcluster(criterion="distance")``: a merge
    joins a flat cluster only when the maximum merge height over its
    whole subtree is <= threshold (centroid linkage can produce
    inversions, so each slot carries its subtree's running maximum).
    """
    parent = np.arange(num_leaves)
    max_height = np.zeros(num_leaves, dtype=np.float64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (i, j), h in zip(np.asarray(merges), np.asarray(heights)):
        i, j = int(i), int(j)
        monocrit = max(float(h), max_height[i], max_height[j])
        if monocrit <= threshold:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[rj] = ri
        max_height[i] = monocrit      # slot i now holds the merged subtree
    roots = np.array([find(x) for x in range(num_leaves)])
    _, clusters = np.unique(roots, return_inverse=True)
    return clusters


def linkage_matrix_from_merges(merges: np.ndarray, heights: np.ndarray,
                               num_leaves: int) -> np.ndarray:
    """The merge sequence in scipy's (N - 1, 4) linkage format: [node_a,
    node_b, height, size], internal nodes numbered ``num_leaves + t`` at
    step ``t``."""
    merges = np.asarray(merges)
    heights = np.asarray(heights, np.float64)
    node_of_slot = np.arange(num_leaves)
    size_of_slot = np.ones(num_leaves, np.int64)
    out = np.zeros((num_leaves - 1, 4), np.float64)
    for t, ((i, j), h) in enumerate(zip(merges, heights)):
        i, j = int(i), int(j)
        a, b = node_of_slot[i], node_of_slot[j]
        size = size_of_slot[i] + size_of_slot[j]
        out[t] = [min(a, b), max(a, b), h, size]
        node_of_slot[i] = num_leaves + t
        size_of_slot[i] = size
    return out


def _merge_sequence(embeddings: np.ndarray, unit_norm: bool,
                    device: Union[str, torch.device]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(embeddings, np.float32)
    if unit_norm:
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        x = x / np.where(norms > 0, norms, 1.0)
    merges, heights = centroid_linkage(torch.from_numpy(x).to(device))
    return merges.cpu().numpy(), heights.cpu().numpy()


def device_linkage(embeddings: np.ndarray, unit_norm: bool = False,
                   device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """scipy-compatible centroid linkage matrix, computed on ``device``."""
    merges, heights = _merge_sequence(embeddings, unit_norm, device)
    return linkage_matrix_from_merges(merges, heights, len(embeddings))


def ahc_on_device(embeddings: np.ndarray, threshold: float,
                  unit_norm: bool = True,
                  device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Centroid-linkage AHC: the linkage on ``device``, the threshold cut
    on the host."""
    merges, heights = _merge_sequence(embeddings, unit_norm, device)
    return fcluster_by_distance(merges, heights, len(embeddings), threshold)
