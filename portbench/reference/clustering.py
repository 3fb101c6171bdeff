"""Plain clustering of per-(chunk, speaker) embeddings, in NumPy / SciPy.

pyannote.audio's ``VBxClustering`` (speaker-diarization-community-1) and
``AgglomerativeClustering``, written from their description:

- train embeddings: finite ones of local speakers active alone on at
  least a fifth of the chunk's frames;
- VBx: centroid linkage of the unit-length train embeddings cut at the
  threshold initialises the VBx EM (Landini et al., 2022; GMM variant,
  initial responsibilities softmax(7 x one-hot), at most 20 iterations,
  ELBO tolerance 1e-4) in the PLDA latent space (x-vector centering,
  length norm, LDA, length norm, then PLDA's simultaneous
  diagonalisation); speakers whose prior exceeds 1e-7 keep a centroid,
  the responsibility-weighted mean of the train embeddings; every
  embedding scores 2 - cosine distance to each centroid, silent local
  speakers lowest, and a Hungarian assignment per chunk gives each local
  speaker its own cluster;
- AHC: the same linkage cut at the threshold, clusters under
  ``min_cluster_size`` merged into the nearest large one, centroids the
  cluster means, each embedding to its closest centroid.

Both run with no bound on the number of speakers, as the benchmark calls
the pipeline.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.linalg import eigh
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist
from scipy.special import logsumexp, softmax


# scores (2 - cosine distance) closer than this are a tie
TIE = 1e-6


def train_rows(embeddings: np.ndarray, clean_frames: np.ndarray,
               num_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    active = clean_frames >= 0.2 * num_frames
    finite = np.all(np.isfinite(embeddings), axis=2)
    return np.where(active & finite)


def unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class Plda:
    """x-vector -> PLDA latent space, from ``xvec_transform.npz`` (mean1,
    mean2, lda) and ``plda.npz`` (mu, tr, psi) arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.mean1, self.mean2 = arrays["mean1"], arrays["mean2"]
        self.lda, self.mu = arrays["lda"], arrays["mu"]
        tr, psi = arrays["tr"], arrays["psi"]
        within = np.linalg.inv(tr.T @ tr)
        between = np.linalg.inv((tr.T / psi) @ tr)
        values, vectors = eigh(between, within)
        self.phi = values[::-1][:self.lda.shape[1]]
        self.projection = vectors.T[::-1]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        def norm(v):
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.where(n > 0, n, 1.0)
        h = np.sqrt(self.lda.shape[0]) * norm(x - self.mean1)
        h = np.sqrt(self.lda.shape[1]) * norm(h @ self.lda - self.mean2)
        return ((h - self.mu) @ self.projection.T)[:, :self.lda.shape[1]]


def vbx(init: np.ndarray, x: np.ndarray, phi: np.ndarray, fa: float,
        fb: float, max_iters: int = 20, epsilon: float = 1e-4
        ) -> Tuple[np.ndarray, np.ndarray]:
    """The VBx EM from AHC labels ``init``; returns (gamma, pi)."""
    one_hot = np.eye(int(init.max()) + 1)[init]
    gamma = softmax(one_hot * 7.0, axis=1)
    pi = np.full(gamma.shape[1], 1.0 / gamma.shape[1])
    const = -0.5 * (np.sum(x ** 2, axis=1, keepdims=True)
                    + x.shape[1] * np.log(2 * np.pi))
    rho = x * np.sqrt(phi)
    previous = -np.inf
    for iteration in range(max_iters):
        inv_l = 1.0 / (1.0 + fa / fb * gamma.sum(axis=0)[:, None] * phi)
        alpha = fa / fb * inv_l * (gamma.T @ rho)
        log_p = fa * (rho @ alpha.T - 0.5 * (inv_l + alpha ** 2) @ phi
                      + const)
        joint = log_p + np.log(pi + 1e-8)
        marginal = logsumexp(joint, axis=-1)
        gamma = np.exp(joint - marginal[:, None])
        pi = gamma.sum(axis=0) / gamma.sum()
        elbo = marginal.sum() + fb * 0.5 * np.sum(
            np.log(inv_l) - inv_l - alpha ** 2 + 1.0)
        if iteration > 0 and elbo - previous < epsilon:
            break
        previous = elbo
    return gamma, pi


def hungarian(soft: np.ndarray) -> np.ndarray:
    soft = np.nan_to_num(soft, nan=np.nanmin(soft))
    hard = np.full(soft.shape[:2], -2, dtype=np.int64)
    for c in range(soft.shape[0]):
        rows, cols = linear_sum_assignment(soft[c], maximize=True)
        hard[c, rows] = cols
    return hard


def vbx_clustering(embeddings: np.ndarray, clean_frames: np.ndarray,
                   speaker_frames: np.ndarray, num_frames: int,
                   plda: Plda, threshold: float, fa: float, fb: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(C, S) hard clusters (-2 where the Hungarian leaves a speaker
    out) and the (C, S, K) scores they were assigned from."""
    C, S, dim = embeddings.shape
    chunks, speakers = train_rows(embeddings, clean_frames, num_frames)
    train = embeddings[chunks, speakers]
    if len(train) < 2:
        return np.zeros((C, S), dtype=np.int64), np.zeros((C, S, 1))
    normed = unit(train)
    ahc = fcluster(linkage(normed, method="centroid", metric="euclidean"),
                   threshold, criterion="distance") - 1
    ahc = np.unique(ahc, return_inverse=True)[1]
    gamma, pi = vbx(ahc, plda(train), plda.phi, fa, fb)
    weights = gamma[:, pi > 1e-7]
    centroids = (weights.T @ train) / np.maximum(
        weights.sum(axis=0)[:, None], 1e-8)
    soft = 2.0 - cdist(embeddings.reshape(-1, dim), centroids,
                       metric="cosine").reshape(C, S, -1)
    soft[speaker_frames == 0] = np.nanmin(soft) - 1.0
    return hungarian(soft), soft


def ahc_clustering(embeddings: np.ndarray, clean_frames: np.ndarray,
                   num_frames: int, threshold: float,
                   min_cluster_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(C, S) hard clusters of centroid-linkage AHC and the (C, S, K)
    scores they were chosen from."""
    C, S, dim = embeddings.shape
    chunks, speakers = train_rows(embeddings, clean_frames, num_frames)
    train = embeddings[chunks, speakers]
    if len(train) < 2:
        return np.zeros((C, S), dtype=np.int64), np.zeros((C, S, 1))
    size = min(min_cluster_size, max(1, round(0.1 * len(train))))
    clusters = fcluster(linkage(unit(train), method="centroid",
                                metric="euclidean"),
                        threshold, criterion="distance") - 1
    labels, counts = np.unique(clusters, return_counts=True)
    large, small = labels[counts >= size], labels[counts < size]
    if len(large) == 0:
        clusters = np.zeros_like(clusters)
    elif len(small):
        means = lambda ks: np.stack(  # noqa: E731
            [train[clusters == k].mean(axis=0) for k in ks])
        nearest = np.argmin(cdist(means(large), means(small),
                                  metric="cosine"), axis=0)
        for i, k in enumerate(small):
            clusters[clusters == k] = large[nearest[i]]
    clusters = np.unique(clusters, return_inverse=True)[1]
    centroids = np.stack([train[clusters == k].mean(axis=0)
                          for k in range(clusters.max() + 1)])
    soft = 2.0 - cdist(embeddings.reshape(-1, dim), centroids,
                       metric="cosine").reshape(C, S, -1)
    return np.argmax(soft, axis=2), soft


class VBx:
    """``vbx_clustering`` at the configuration's parameters, in its
    PLDA's space; the Hungarian chooses a chunk's clusters together."""

    per_chunk = True

    def __init__(self, params: dict, weights: dict):
        self.params, self.plda = params, Plda(weights["plda"])

    def __call__(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                 speaker_frames: np.ndarray, num_frames: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        p = self.params
        return vbx_clustering(embeddings, clean_frames, speaker_frames,
                              num_frames, self.plda, p["threshold"], p["Fa"],
                              p["Fb"])


class AHC:
    """``ahc_clustering`` at the configuration's parameters; each pair
    chooses its cluster alone."""

    per_chunk = False

    def __init__(self, params: dict, weights: dict):
        self.params = params

    def __call__(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                 speaker_frames: np.ndarray, num_frames: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return ahc_clustering(embeddings, clean_frames, num_frames,
                              self.params["threshold"],
                              self.params["min_cluster_size"])


KINDS = {"vbx": VBx, "ahc": AHC}


def method(kind: str, params: dict, weights: dict):
    """The clustering of ``kind``: called with (embeddings, clean frames,
    speaker frames, frames a chunk), it returns (hard clusters, the scores
    they were assigned from)."""
    return KINDS[kind](params, weights)


def moved(ours: np.ndarray, theirs: np.ndarray, soft: np.ndarray,
          active: np.ndarray, per_chunk: bool, tie: float = TIE) -> int:
    """Active pairs whose cluster in ``ours`` differs from ``theirs``
    (chosen from the scores ``soft``) where ``ours`` scores lower than
    ``theirs`` by more than ``tie``: per pair for AHC's choice, per chunk
    (the Hungarian's sum over the chunk's active pairs) with
    ``per_chunk``. Two choices within ``tie`` of each other are a tie,
    which rounding in the last place may settle either way."""
    soft = np.nan_to_num(soft, nan=np.nanmin(soft))
    K = soft.shape[2]

    def score(hard):
        inside = (hard >= 0) & (hard < K)
        picked = np.take_along_axis(soft, np.clip(hard, 0, K - 1)[..., None],
                                    axis=2)[..., 0]
        return np.where(active, np.where(inside, picked, -np.inf), 0.0)
    differs = (ours != theirs) & active
    if per_chunk:
        worse = score(ours).sum(axis=1) < score(theirs).sum(axis=1) - tie
        return int((differs & worse[:, None]).sum())
    return int((differs & (score(ours) < score(theirs) - tie)).sum())
