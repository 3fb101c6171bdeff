"""Clustering of per-(chunk, speaker) embeddings.

Counterpart of pyannote_audio_tpu/pipelines/clustering.py: agglomerative,
KMeans, VBx (in a PLDA space) and oracle clustering over the (num_chunks,
num_speakers, dim) embeddings, with NaN and low-activity filtering,
closest-centroid (optionally per-chunk Hungarian) assignment and cluster
count constraints. The embedding matrices are small, so numpy and scipy
do it on the host. KMeans is the port's own ``ops/kmeans.py`` (not
scikit-learn's), on the host or, where PYANNOTE_TPU_DEVICE_KMEANS is "1",
on the pipeline's device; VBx's EM runs on the device where
PYANNOTE_TPU_DEVICE_VBX is "1" (``utils/vbx.py``); the centroid linkage of
agglomerative clustering runs on the device where PYANNOTE_TPU_DEVICE_AHC
is "1" (``ops/ahc.py``). VBx's initial linkage stays on the host, as in
the JAX package. All three gates are off by default.

A call takes the embeddings and the per-(chunk, speaker) clean-speech
frame counts that ``ops.diarize_fused.fused_count_stats`` computes, with
the chunks' frame count; VBx also takes the active-frame counts
(``speaker_frames``), and oracle clustering the file, its binarized
segmentation and the model's frames.

While spans are recorded (``telemetry/spans.py``), a call opens
``linkage`` (agglomerative: the dendrogram and its cut, on the host or
the device; VBx: its AHC initialization), ``vbx`` (VBx: the PLDA
transform and the EM) and ``assign`` (the centroids and the assignment).
"""

from __future__ import annotations

import warnings
from enum import Enum
from typing import Optional, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from ..core.parameter import Categorical, Integer, Uniform
from ..core.pipeline import Pipeline
from ..core.plda import PLDA
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..ops.ahc import device_linkage
from ..ops.kmeans import kmeans
from ..telemetry.spans import span
from ..utils.runtime import device_flag
from ..utils.vbx import cluster_vbx


class BaseClustering(Pipeline):
    """Shared orchestration: filter -> cluster -> assign."""

    expects_num_clusters: bool = False

    def __init__(self, metric: str = "cosine",
                 constrained_assignment: bool = False):
        super().__init__()
        self.metric = metric
        self.constrained_assignment = constrained_assignment
        # where the opt-in device paths run; Pipeline.to moves it
        self.device = "cpu"

    def set_num_clusters(self, num_embeddings: int,
                         num_clusters: Optional[int] = None,
                         min_clusters: Optional[int] = None,
                         max_clusters: Optional[int] = None):
        """Resolve (num, min, max) cluster-count constraints."""
        min_clusters = num_clusters or min_clusters or 1
        min_clusters = max(1, min(num_embeddings, min_clusters))
        max_clusters = num_clusters or max_clusters or num_embeddings
        max_clusters = max(1, min(num_embeddings, max_clusters))
        if min_clusters > max_clusters:
            raise ValueError(
                f"min_clusters ({min_clusters}) must be <= max_clusters "
                f"({max_clusters})")
        if min_clusters == max_clusters:
            num_clusters = min_clusters
        return num_clusters, min_clusters, max_clusters

    def filter_embeddings(self, embeddings: np.ndarray,
                          clean_frames: np.ndarray, num_frames: int,
                          min_active_ratio: float = 0.2
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Keep NaN-free embeddings of speakers active *alone* for at
        least ``min_active_ratio`` of the chunk's ``num_frames``.

        ``clean_frames`` (chunks, speakers) comes from
        ``ops.diarize_fused.fused_count_stats``.
        """
        active = clean_frames >= min_active_ratio * num_frames
        valid = ~np.any(np.isnan(embeddings), axis=2)
        chunk_idx, speaker_idx = np.where(active & valid)
        return embeddings[chunk_idx, speaker_idx], chunk_idx, speaker_idx

    def constrained_argmax(self, soft_clusters: np.ndarray) -> np.ndarray:
        """Per-chunk Hungarian: each local speaker -> a distinct cluster."""
        soft = np.nan_to_num(soft_clusters, nan=np.nanmin(soft_clusters))
        num_chunks, num_speakers, _ = soft.shape
        hard = np.full((num_chunks, num_speakers), -2, dtype=np.int8)
        for c in range(num_chunks):
            speakers, clusters = linear_sum_assignment(soft[c],
                                                       maximize=True)
            hard[c, speakers] = clusters
        return hard

    def assign_embeddings(self, embeddings: np.ndarray,
                          train_chunk_idx: np.ndarray,
                          train_speaker_idx: np.ndarray,
                          train_clusters: np.ndarray,
                          constrained: bool = False):
        """Centroids from the train subset, then closest-centroid
        assignment of every embedding."""
        # dense relabel: a KMeans id may have no member, whose centroid
        # would give a NaN cosine column
        train_clusters = np.unique(np.asarray(train_clusters),
                                   return_inverse=True)[1]
        num_clusters = int(np.max(train_clusters)) + 1
        num_chunks, num_speakers, dim = embeddings.shape
        train = embeddings[train_chunk_idx, train_speaker_idx]
        centroids = np.stack([train[train_clusters == k].mean(axis=0)
                              for k in range(num_clusters)])
        dist = cdist(embeddings.reshape(-1, dim), centroids,
                     metric=self.metric)
        soft_clusters = 2.0 - dist.reshape(num_chunks, num_speakers,
                                           num_clusters)
        if constrained:
            hard_clusters = self.constrained_argmax(soft_clusters)
        else:
            hard_clusters = np.argmax(soft_clusters, axis=2)
        return hard_clusters, soft_clusters, centroids

    def _kmeans(self, embeddings: np.ndarray, num_clusters: int
                ) -> np.ndarray:
        """``ops.kmeans.kmeans`` on the host, or on the pipeline's device
        where PYANNOTE_TPU_DEVICE_KMEANS is "1"."""
        device = self.device if device_flag(
            "PYANNOTE_TPU_DEVICE_KMEANS", self.device,
            accelerator_default=False) else "cpu"
        return kmeans(embeddings, num_clusters, device=device)

    def cluster(self, embeddings: np.ndarray, min_clusters: int,
                max_clusters: int,
                num_clusters: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                 num_frames: int, num_clusters: Optional[int] = None,
                 min_clusters: Optional[int] = None,
                 max_clusters: Optional[int] = None, **kwargs):
        """-> (hard_clusters (C, S), soft_clusters (C, S, K), centroids)."""
        train, chunk_idx, speaker_idx = self.filter_embeddings(
            embeddings, clean_frames, num_frames)
        num_clusters, min_clusters, max_clusters = self.set_num_clusters(
            train.shape[0], num_clusters=num_clusters,
            min_clusters=min_clusters, max_clusters=max_clusters)
        if max_clusters < 2:
            return _single_cluster(embeddings, train)
        train_clusters = self.cluster(train, min_clusters=min_clusters,
                                      max_clusters=max_clusters,
                                      num_clusters=num_clusters)
        with span("assign"):
            return self.assign_embeddings(
                embeddings, chunk_idx, speaker_idx, train_clusters,
                constrained=self.constrained_assignment)


def _single_cluster(embeddings: np.ndarray, train: np.ndarray):
    """Everything in one cluster, centred on the train embeddings."""
    num_chunks, num_speakers, dim = embeddings.shape
    hard = np.zeros((num_chunks, num_speakers), dtype=np.int8)
    soft = np.ones((num_chunks, num_speakers, 1))
    centroids = np.mean(train, axis=0, keepdims=True) \
        if len(train) else np.zeros((1, dim))
    return hard, soft, centroids


def _unit(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)


class AgglomerativeClustering(BaseClustering):
    """Hierarchical clustering with threshold / count constraints.

    Hyperparameters: ``method`` (a scipy linkage method), ``threshold``
    (cut distance) and ``min_cluster_size``.
    """

    def __init__(self, metric: str = "cosine",
                 constrained_assignment: bool = False):
        super().__init__(metric=metric,
                         constrained_assignment=constrained_assignment)
        self.threshold = Uniform(0.0, 2.0)
        self.method = Categorical(["average", "centroid", "complete",
                                   "median", "single", "ward", "weighted"])
        self.min_cluster_size = Integer(1, 20)

    def cluster(self, embeddings: np.ndarray, min_clusters: int,
                max_clusters: int,
                num_clusters: Optional[int] = None) -> np.ndarray:
        num_embeddings = embeddings.shape[0]
        min_cluster_size = min(self.min_cluster_size,
                               max(1, round(0.1 * num_embeddings)))
        if num_embeddings == 1:
            return np.zeros((1,), dtype=np.uint8)

        with span("linkage"):
            # centroid/median/ward need euclidean: unit-normalize instead
            if self.metric == "cosine" and \
                    self.method in ("centroid", "median", "ward"):
                if self.method == "centroid" and device_flag(
                        "PYANNOTE_TPU_DEVICE_AHC", self.device,
                        accelerator_default=False):
                    dendrogram = device_linkage(_unit(embeddings),
                                                device=self.device)
                else:
                    dendrogram = linkage(_unit(embeddings),
                                         method=self.method,
                                         metric="euclidean")
            else:
                dendrogram = linkage(embeddings, method=self.method,
                                     metric=self.metric)
            clusters = fcluster(dendrogram, self.threshold,
                                criterion="distance") - 1

        def large_of(assign):
            uniq, counts = np.unique(assign, return_counts=True)
            return uniq, counts, uniq[counts >= min_cluster_size]

        uniq, counts, large = large_of(clusters)
        if len(large) < min_clusters:
            num_clusters = min_clusters
        elif len(large) > max_clusters:
            num_clusters = max_clusters

        if num_clusters is not None and len(large) != num_clusters:
            # re-cut the dendrogram by iteration index, closest to the
            # threshold first, until the large-cluster count matches
            by_iteration = np.copy(dendrogram)
            by_iteration[:, 2] = np.arange(num_embeddings - 1)
            best_it, best_num = num_embeddings - 1, 1
            for it in np.argsort(np.abs(dendrogram[:, 2] - self.threshold)):
                if by_iteration[it, 3] < min_cluster_size:
                    continue
                candidate = fcluster(by_iteration, it,
                                     criterion="distance") - 1
                _, _, cand_large = large_of(candidate)
                clusters = candidate
                if abs(len(cand_large) - num_clusters) < \
                        abs(best_num - num_clusters):
                    best_it, best_num = it, len(cand_large)
                if len(cand_large) == num_clusters:
                    break
            if best_num != num_clusters:
                clusters = fcluster(by_iteration, best_it,
                                    criterion="distance") - 1
                warnings.warn(
                    f"Found only {best_num} clusters. Using a smaller "
                    f"value than {min_cluster_size} for "
                    f"`min_cluster_size` might help.")
            uniq, counts, large = large_of(clusters)

        if len(large) == 0:
            return np.zeros_like(clusters)
        small = uniq[counts < min_cluster_size]
        if len(small) > 0:
            # merge each small cluster into its closest large cluster
            large_centroids = np.stack(
                [embeddings[clusters == k].mean(axis=0) for k in large])
            small_centroids = np.stack(
                [embeddings[clusters == k].mean(axis=0) for k in small])
            nearest = np.argmin(
                cdist(large_centroids, small_centroids, metric=self.metric),
                axis=0)
            for i, k in enumerate(small):
                clusters[clusters == k] = large[nearest[i]]
        _, clusters = np.unique(clusters, return_inverse=True)
        return clusters


class KMeansClustering(BaseClustering):
    """Seeded KMeans (``ops/kmeans.py``); needs a known cluster count."""

    expects_num_clusters = True

    def __init__(self, metric: str = "cosine"):
        if metric not in ("cosine", "euclidean"):
            raise ValueError("metric must be 'cosine' or 'euclidean'")
        super().__init__(metric=metric)

    def cluster(self, embeddings: np.ndarray, min_clusters: int,
                max_clusters: int,
                num_clusters: Optional[int] = None) -> np.ndarray:
        if num_clusters is None:
            raise ValueError("`num_clusters` must be provided.")
        num_embeddings = embeddings.shape[0]
        if num_embeddings < num_clusters:
            return np.arange(num_embeddings, dtype=np.int32)
        if self.metric == "cosine":
            embeddings = _unit(embeddings)
        return self._kmeans(embeddings, num_clusters)


class VBxClustering(BaseClustering):
    """AHC-initialized variational Bayes clustering in PLDA space.

    Hyperparameters: ``threshold`` (the AHC cut that initializes VBx),
    ``Fa`` and ``Fb``. A count outside the constraints falls back to
    KMeans over the unit-normalized embeddings. With the (default)
    constrained assignment, local speakers with no active frame are held
    below every valid score, so the per-chunk Hungarian never gives them
    a cluster another speaker of the chunk needs.
    """

    def __init__(self, plda: PLDA, metric: str = "cosine",
                 constrained_assignment: bool = True):
        super().__init__(metric=metric,
                         constrained_assignment=constrained_assignment)
        self.plda = plda
        self.threshold = Uniform(0.5, 0.8)
        self.Fa = Uniform(0.01, 0.5)
        self.Fb = Uniform(0.01, 15.0)

    def __call__(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                 num_frames: int, num_clusters: Optional[int] = None,
                 min_clusters: Optional[int] = None,
                 max_clusters: Optional[int] = None,
                 speaker_frames: Optional[np.ndarray] = None, **kwargs):
        """``speaker_frames`` (chunks, speakers): each local speaker's
        active frames, which the constrained assignment needs."""
        constrained = self.constrained_assignment
        if constrained and speaker_frames is None:
            raise ValueError("the constrained assignment of VBx clustering "
                             "needs speaker_frames")
        train, _, _ = self.filter_embeddings(embeddings, clean_frames,
                                             num_frames)
        num_chunks, num_speakers, dim = embeddings.shape
        if train.shape[0] < 2:
            return _single_cluster(embeddings, train)

        # the resolved count is clamped to the surviving embeddings, so
        # the KMeans fallback never asks for more clusters than samples
        num_clusters, min_clusters, max_clusters = self.set_num_clusters(
            train.shape[0], num_clusters=num_clusters,
            min_clusters=min_clusters, max_clusters=max_clusters)

        # AHC initialization on unit-normalized embeddings
        normed = train / np.linalg.norm(train, axis=1, keepdims=True)
        with span("linkage"):
            dendrogram = linkage(normed, method="centroid",
                                 metric="euclidean")
            ahc = fcluster(dendrogram, self.threshold,
                           criterion="distance") - 1
        _, ahc = np.unique(ahc, return_inverse=True)

        # VBx EM in the PLDA latent space
        with span("vbx"):
            gamma, pi = cluster_vbx(ahc, self.plda(train), self.plda.phi,
                                    fa=self.Fa, fb=self.Fb, max_iters=20,
                                    device=self.device)
        with span("assign"):
            # centroids from the responsibilities of surviving speakers
            keep = pi > 1e-7
            weights = gamma[:, keep]                           # (T, S_kept)
            totals = np.maximum(weights.sum(axis=0)[:, None], 1e-8)
            centroids = (weights.T @ train) / totals

            # KMeans when the count constraints are violated
            auto = centroids.shape[0]
            if auto < min_clusters:
                num_clusters = min_clusters
            elif auto > max_clusters:
                num_clusters = max_clusters
            if num_clusters and num_clusters != auto:
                constrained = False
                km = self._kmeans(normed, num_clusters)
                # an id the port's KMeans left without members gets no centroid
                centroids = np.stack([train[km == k].mean(axis=0)
                                      for k in np.unique(km)])

            dist = cdist(embeddings.reshape(-1, dim), centroids,
                         metric=self.metric)
            soft = 2.0 - dist.reshape(num_chunks, num_speakers, -1)
            if constrained:
                # silent local speakers below any valid score (nanmin: a NaN
                # embedding row would make min() NaN, which nan_to_num in
                # constrained_argmax turns into a tie with the valid scores)
                soft[speaker_frames == 0] = np.nanmin(soft) - 1.0
                hard = self.constrained_argmax(soft)
            else:
                hard = np.argmax(soft, axis=2)
            return hard.reshape(num_chunks, num_speakers), soft, centroids


class OracleClustering(BaseClustering):
    """Perfect clustering derived from the reference annotation."""

    expects_num_clusters = True

    def __call__(self, embeddings: Optional[np.ndarray] = None,
                 clean_frames: Optional[np.ndarray] = None,
                 num_frames: Optional[int] = None,
                 segmentations: Optional[SlidingWindowFeature] = None,
                 file=None, frames: Optional[SlidingWindow] = None,
                 **kwargs):
        """``segmentations``: the binarized (chunks, frames, speakers)
        scores on the host; ``frames``: the model's output frames."""
        from ..ops.permutation import permutate
        from .utils.oracle import oracle_segmentation

        num_chunks, seg_frames, num_speakers = segmentations.data.shape
        oracle = oracle_segmentation(file, segmentations.sliding_window,
                                     frames=frames)
        file["oracle_segmentations"] = oracle
        _, oracle_frames, num_clusters = oracle.data.shape
        n = min(seg_frames, oracle_frames)
        seg_data = segmentations.data[:, :n]
        oracle_data = oracle.data[:, :n]

        hard = np.full((num_chunks, num_speakers), -2, dtype=np.int8)
        soft = np.zeros((num_chunks, num_speakers, num_clusters))
        for c in range(num_chunks):
            _, perms = permutate(oracle_data[c][None], seg_data[c])
            for j, i in enumerate(perms[0]):
                if i is None:
                    continue
                hard[c, i] = j
                soft[c, i, j] = 1.0

        if embeddings is None:
            return hard, soft, None
        train, chunk_idx, speaker_idx = self.filter_embeddings(
            embeddings, clean_frames, num_frames)
        train_clusters = hard[chunk_idx, speaker_idx]
        centroids = np.stack([
            train[train_clusters == k].mean(axis=0)
            if np.any(train_clusters == k)
            else np.zeros(embeddings.shape[-1])
            for k in range(num_clusters)])
        return hard, soft, centroids


class Clustering(Enum):
    AgglomerativeClustering = AgglomerativeClustering
    KMeansClustering = KMeansClustering
    VBxClustering = VBxClustering
    OracleClustering = OracleClustering
