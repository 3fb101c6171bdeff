"""Agglomerative clustering of per-(chunk, speaker) embeddings, on the host.

Counterpart of the host path of pyannote_audio_tpu/pipelines/clustering.py
(``BaseClustering`` and ``AgglomerativeClustering``): filter the
embeddings by clean-speech activity, cluster them with scipy's linkage
under count constraints, then assign every embedding to its closest
centroid. The embedding matrices are small, so numpy and scipy do it.
VBx, KMeans and oracle clustering are not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import cdist

from ..core.pipeline import Pipeline


class BaseClustering(Pipeline):
    """Shared orchestration: filter -> cluster -> assign."""

    def __init__(self, metric: str = "cosine"):
        self.metric = metric

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

    def assign_embeddings(self, embeddings: np.ndarray,
                          train_chunk_idx: np.ndarray,
                          train_speaker_idx: np.ndarray,
                          train_clusters: np.ndarray):
        """Centroids from the train subset, then closest-centroid
        assignment of every embedding."""
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
        return np.argmax(soft_clusters, axis=2), soft_clusters, centroids

    def cluster(self, embeddings: np.ndarray, min_clusters: int,
                max_clusters: int,
                num_clusters: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                 num_frames: int, num_clusters: Optional[int] = None,
                 min_clusters: Optional[int] = None,
                 max_clusters: Optional[int] = None):
        """-> (hard_clusters (C, S), soft_clusters (C, S, K), centroids)."""
        train, chunk_idx, speaker_idx = self.filter_embeddings(
            embeddings, clean_frames, num_frames)
        num_clusters, min_clusters, max_clusters = self.set_num_clusters(
            train.shape[0], num_clusters=num_clusters,
            min_clusters=min_clusters, max_clusters=max_clusters)
        if max_clusters < 2:
            num_chunks, num_speakers, dim = embeddings.shape
            hard = np.zeros((num_chunks, num_speakers), dtype=np.int8)
            soft = np.ones((num_chunks, num_speakers, 1))
            centroids = np.mean(train, axis=0, keepdims=True) \
                if len(train) else np.zeros((1, dim))
            return hard, soft, centroids
        train_clusters = self.cluster(train, min_clusters=min_clusters,
                                      max_clusters=max_clusters,
                                      num_clusters=num_clusters)
        return self.assign_embeddings(embeddings, chunk_idx, speaker_idx,
                                      train_clusters)


class AgglomerativeClustering(BaseClustering):
    """Hierarchical clustering with threshold / count constraints.

    Hyperparameters (set by ``instantiate``): ``method`` (a scipy linkage
    method), ``threshold`` (cut distance) and ``min_cluster_size``.
    """

    def cluster(self, embeddings: np.ndarray, min_clusters: int,
                max_clusters: int,
                num_clusters: Optional[int] = None) -> np.ndarray:
        num_embeddings = embeddings.shape[0]
        min_cluster_size = min(self.min_cluster_size,
                               max(1, round(0.1 * num_embeddings)))
        if num_embeddings == 1:
            return np.zeros((1,), dtype=np.uint8)

        # centroid/median/ward need euclidean: unit-normalize instead
        if self.metric == "cosine" and \
                self.method in ("centroid", "median", "ward"):
            with np.errstate(divide="ignore", invalid="ignore"):
                embeddings = embeddings / np.linalg.norm(
                    embeddings, axis=-1, keepdims=True)
            dendrogram = linkage(embeddings, method=self.method,
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
