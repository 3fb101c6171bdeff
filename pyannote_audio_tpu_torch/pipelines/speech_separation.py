"""Speech separation pipeline (PixIT inference).

Counterpart of pyannote_audio_tpu/pipelines/speech_separation.py: a
ToTaToNet-like model (diarization scores and separated sources per
chunk) over a sliding window; the diarization follows the count-
constrained reconstruction; each chunk's local sources are clustered
into global speakers (by the embedding model when one is given, else by
their activity patterns) and overlap-added per speaker; a speaker's
source is zeroed where the speaker is inactive (leakage removal, dilated
by ``asr_collar``) and peak-normalised.

As the JAX package serves it: the padded waveform is uploaded once, as
exact float32, and the chunks are strided views of it on the device; the
per-batch outputs stay on the device; only the diarization scores come to
the host (binarization, count, clustering and reconstruction run there,
with the JAX package's numbers); the clustered sources are overlap-added
on the device by a one-hot projection of each chunk's hard clusters, so
only the (samples, clusters) result crosses to the host. ``device`` is the
CUDA card by default and raises without one; ``device="cpu"`` runs on the
CPU.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from scipy.ndimage import binary_dilation

from ..core.annotation import Annotation
from ..core.inference import (Inference, _chunk_grid,
                              _upload_waveform_cached, pad_to_grid)
from ..core.io import Audio
from ..core.model import first_specifications
from ..core.parameter import Categorical, ParamDict, Uniform
from ..core.pipeline import Pipeline, check_device
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..metrics.der import GreedyDiarizationErrorRate
from ..utils.signal import binarize_swf
from .clustering import Clustering, OracleClustering
from .speaker_diarization import (DiarizeOutput, EmbeddingMixin,
                                  SpeakerDiarization)
from .utils.diarization import SpeakerDiarizationMixin, set_num_speakers
from .utils.getter import PipelineModel, get_model


@dataclass
class SeparationOutput(DiarizeOutput):
    """DiarizeOutput + the sources, (num_samples, num_speakers) in the
    diarization's label order."""

    sources: Optional[np.ndarray] = None


class SpeechSeparation(SpeakerDiarizationMixin, EmbeddingMixin, Pipeline):
    """Joint diarization and separation with a ToTaToNet-like model.

    ``segmentation`` returns (diarization (B, frames, sources), sources
    (B, samples, sources)) per chunk; ``embedding`` (optional) clusters
    the local sources by embedding, as in ``SpeakerDiarization``.
    """

    def __init__(self, segmentation: PipelineModel = None,
                 embedding: Optional[PipelineModel] = None,
                 clustering: str = "AgglomerativeClustering",
                 segmentation_step: float = 0.1,
                 embedding_batch_size: int = 32,
                 segmentation_batch_size: int = 32,
                 der_variant: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = check_device(device)
        if segmentation is None:
            raise ValueError("a segmentation model is required")
        if clustering == "VBxClustering":
            raise ValueError("VBx clustering needs x-vector embeddings and "
                             "a PLDA; separation takes "
                             "AgglomerativeClustering, KMeansClustering or "
                             "OracleClustering")
        try:
            Klustering = Clustering[clustering].value
        except KeyError:
            raise ValueError(f"clustering must be one of "
                             f"{[member.name for member in Clustering]}")
        self.segmentation_step = segmentation_step
        self.embedding_batch_size = embedding_batch_size
        self.klustering = clustering
        self.der_variant = der_variant or {"collar": 0.0,
                                           "skip_overlap": False}
        model = get_model(segmentation).to(self.device).eval()
        duration = first_specifications(model.specifications).duration
        self._segmentation = Inference(
            model, duration=duration, step=segmentation_step * duration,
            skip_aggregation=True, batch_size=segmentation_batch_size,
            device=self.device)
        self.segmentation = ParamDict(min_duration_off=Uniform(0.0, 1.0),
                                      threshold=Uniform(0.1, 0.9))
        self.separation = ParamDict(
            leakage_removal=Categorical([True, False]),
            asr_collar=Uniform(0.0, 1.0))
        self._embedding = get_model(embedding).to(self.device).eval() \
            if embedding is not None else None
        self._replicate_embedding()
        self._audio = Audio(sample_rate=model.sample_rate, mono="downmix")
        self.clustering = OracleClustering() \
            if Klustering is OracleClustering else Klustering(metric="cosine")
        self.clustering.to(self.device)
        self.counts = {"whole_fbank": 0, "trunk_panel_batches": 0,
                       "chunk_trunk_batches": 0}

    def default_parameters(self) -> Dict[str, Any]:
        return {"segmentation": {"min_duration_off": 0.0, "threshold": 0.5},
                "separation": {"leakage_removal": True, "asr_collar": 0.1},
                "clustering": {"method": "centroid", "threshold": 0.6,
                               "min_cluster_size": 1}}

    def get_metric(self) -> GreedyDiarizationErrorRate:
        return GreedyDiarizationErrorRate(**self.der_variant)

    classes = staticmethod(SpeakerDiarization.classes)

    @torch.inference_mode()
    def _separate(self, waveform: np.ndarray, sample_rate: int, file):
        """Chunk-level diarization scores on the host and sources on the
        device, and the chunk starts (samples) and padded length."""
        inference = self._segmentation
        window = round(inference.duration * sample_rate)
        step = round(inference.step * sample_rate)
        starts, padded_len = _chunk_grid(waveform.shape[1], window, step)
        buffer = pad_to_grid(_upload_waveform_cached(
            waveform, file if isinstance(file, Mapping) else None,
            self.device), window, step)
        diarization, sources = inference._slide_scores(buffer, starts,
                                                       window, False)
        return diarization.cpu().numpy(), sources, starts, padded_len

    @torch.inference_mode()
    def _overlap_add(self, sources: torch.Tensor, hard_clusters: np.ndarray,
                     starts: np.ndarray, padded_len: int,
                     num_samples: int) -> np.ndarray:
        """Each chunk's (window, local) sources projected on the global
        clusters by the one-hot of its hard clusters (negative: dropped),
        summed at the chunk's offset and divided by the number of
        contributions (at least 1): (num_samples, clusters) on the host.

        Chunks go in rounds of ceil(window / step) that do not overlap
        among themselves, so no index repeats within an ``index_add_``
        and the sums' order is fixed.
        """
        num_chunks, window, _ = sources.shape
        num_clusters = int(np.max(hard_clusters)) + 1
        device = sources.device
        clusters = torch.from_numpy(
            np.asarray(hard_clusters, dtype=np.int64)).to(device)
        onehot = torch.nn.functional.one_hot(
            clusters.clamp(min=0), num_clusters).to(sources.dtype) \
            * (clusters >= 0)[..., None]                   # (C, local, K)
        first = torch.from_numpy(starts).to(device)
        total = sources.new_zeros((padded_len, num_clusters))
        # contributions per sample: a step function of the chunk bounds
        steps = sources.new_zeros((padded_len + 1, num_clusters))
        weight = onehot.sum(dim=1)                           # (C, K)
        steps.index_add_(0, first, weight)
        steps.index_add_(0, first + window, -weight)
        offsets = torch.arange(window, device=device)
        step = int(starts[1] - starts[0]) if len(starts) > 1 else window
        rounds = -(-window // step)
        for r in range(rounds):
            idx = (first[r::rounds, None] + offsets).reshape(-1)
            contrib = torch.bmm(sources[r::rounds], onehot[r::rounds])
            total.index_add_(0, idx, contrib.reshape(-1, num_clusters))
        counts = torch.cumsum(steps, dim=0)[:num_samples]
        return (total[:num_samples] / torch.clamp(counts, min=1.0)) \
            .cpu().numpy()

    def apply(self, file: Dict, num_speakers: Optional[int] = None,
              min_speakers: Optional[int] = None,
              max_speakers: Optional[int] = None,
              hook: Optional[Callable] = None, **kwargs
              ) -> SeparationOutput:
        hook = self.setup_hook(file, hook=hook)
        num_speakers, min_speakers, max_speakers = set_num_speakers(
            num_speakers=num_speakers, min_speakers=min_speakers,
            max_speakers=max_speakers)
        waveform, sample_rate = self._audio(file)
        num_samples = waveform.shape[1]
        model = self._segmentation.model
        scores, sources, starts, padded_len = self._separate(
            waveform, sample_rate, file)
        segmentations = SlidingWindowFeature(scores, SlidingWindow(
            start=0.0, duration=self._segmentation.duration,
            step=self._segmentation.step))
        hook("segmentation", segmentations)

        binarized = binarize_swf(segmentations,
                                 onset=self.segmentation.threshold,
                                 initial_state=False)
        count = self.speaker_count(binarized, model.receptive_field,
                                   warm_up=(0.0, 0.0))
        hook("speaker_counting", count)
        if np.nanmax(count.data) == 0.0:
            return SeparationOutput(Annotation(uri=file["uri"]),
                                    Annotation(uri=file["uri"]), None,
                                    np.zeros((num_samples, 0)))

        seg = binarized.data
        if self._embedding is not None:
            embeddings = self.get_embeddings(
                waveform, SlidingWindowFeature(
                    torch.from_numpy(seg).to(self.device),
                    binarized.sliding_window),
                exclude_overlap=False, hook=hook, cache=file)
        else:
            # the local sources' activity patterns stand for embeddings
            embeddings = np.transpose(seg, (0, 2, 1))
        # frames where a speaker is active alone (the JAX package's
        # filter_embeddings on host scores)
        alone = np.sum(seg, axis=2, keepdims=True) == 1
        hard_clusters, _, centroids = self.clustering(
            embeddings, np.sum(seg * alone, axis=1),
            num_frames=seg.shape[1], num_clusters=num_speakers,
            min_clusters=min_speakers, max_clusters=max_speakers,
            segmentations=binarized, file=file,
            frames=model.receptive_field)
        hard_clusters = np.array(hard_clusters)

        count.data = np.minimum(count.data, max_speakers).astype(np.int8)
        hard_clusters[np.sum(seg, axis=1) == 0] = -2        # inactive
        min_duration_off = self.segmentation.min_duration_off
        discrete = self.reconstruct(segmentations, hard_clusters, count)
        diarization = self.to_annotation(discrete,
                                         min_duration_off=min_duration_off)
        diarization.uri = file["uri"]
        count.data = np.minimum(count.data, 1).astype(np.int8)
        exclusive = self.to_annotation(
            self.reconstruct(segmentations, hard_clusters, count),
            min_duration_off=min_duration_off)
        exclusive.uri = file["uri"]

        separated = self._overlap_add(sources, hard_clusters, starts,
                                      padded_len, num_samples)
        del sources
        separated = apply_leakage_mask(
            separated, diarization, sample_rate,
            leakage_removal=bool(self.separation.leakage_removal),
            asr_collar=float(self.separation.asr_collar))
        # SI-SDR training leaves the scale free: peak-normalise each one
        separated = separated / (
            np.max(np.abs(separated), axis=0, keepdims=True) + 1e-8)

        # labels: the reference's by the Hungarian mapping when the file
        # has an annotation, else SPEAKER_{i:02d} in numeric cluster order
        numeric = sorted(int(label) for label in diarization.labels()
                         if isinstance(label, (int, np.integer)))
        if isinstance(file, Mapping) and file.get("annotation"):
            _, mapping = self.optimal_mapping(
                file["annotation"], diarization, return_mapping=True)
            mapping = {label: mapping.get(label, label)
                       for label in diarization.labels()}
        else:
            mapping = dict(zip(numeric, self.classes()))
        diarization = diarization.rename_labels(mapping)
        exclusive = exclusive.rename_labels(mapping)

        # sources and centroids in the labels' order, with zero columns
        # and rows for speakers that the reconstruction added beyond the
        # clusters
        inverse = {new: old for old, new in mapping.items()}
        order = [int(inverse[label]) for label in diarization.labels()]
        if order:
            need = max(order) + 1
            if need > separated.shape[1]:
                separated = np.pad(separated,
                                   ((0, 0), (0, need - separated.shape[1])))
            separated = separated[:, order]
            if centroids is not None:
                if need > centroids.shape[0]:
                    centroids = np.pad(
                        centroids, ((0, need - centroids.shape[0]), (0, 0)))
                centroids = centroids[order]
        return SeparationOutput(diarization, exclusive, centroids, separated)


def apply_leakage_mask(sources: np.ndarray, diarization: Annotation,
                       sample_rate: int, leakage_removal: bool = True,
                       asr_collar: float = 0.1) -> np.ndarray:
    """Zero each cluster's source where the (integer-labelled) diarization
    has it inactive, its activity first dilated by ``asr_collar`` seconds
    on each side (scipy's ``binary_dilation``, as the JAX package)."""
    if not leakage_removal:
        return sources
    num_samples, num_clusters = sources.shape
    collar = int(round(asr_collar * sample_rate))
    out = sources.copy()
    for k in range(num_clusters):
        active = np.zeros(num_samples, dtype=bool)
        for segment, _, label in diarization.itertracks(yield_label=True):
            if label == k:
                i0 = int(segment.start * sample_rate)
                i1 = int(segment.end * sample_rate)
                active[max(0, i0):min(num_samples, i1)] = True
        if collar > 0:
            active = binary_dilation(active, structure=np.ones(2 * collar))
        out[~active, k] = 0.0
    return out
