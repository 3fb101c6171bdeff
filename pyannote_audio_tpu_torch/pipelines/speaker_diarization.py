"""Speaker diarization pipeline.

Counterpart of pyannote_audio_tpu/pipelines/speaker_diarization.py on the
JAX package's exact path (the one it takes on the CPU): sliding-window
segmentation -> speaker count and activity statistics -> one embedding
per (chunk, speaker), the ResNet trunk running once per chunk and
speaker masks acting only at pooling -> host clustering ->
count-constrained reconstruction -> Annotation.

Everything up to the embeddings stays on ``device``; clustering runs on
the host, then reconstruction runs on the device again. Files are
processed one after another. Not ported yet: the shared whole-file sinc
front-end, fbank and trunk, the bf16 fast paths, pipelined batches on
CUDA streams, hooks, VBx/KMeans/oracle clustering, and renaming labels
after a reference annotation (labels are always SPEAKER_00, ...).
"""

from __future__ import annotations

import math
import textwrap
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.annotation import Annotation
from ..core.inference import Inference, chunk_views
from ..core.io import Audio
from ..core.pipeline import Pipeline
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..ops.diarize_fused import (fused_count_stats, fused_reconstruct,
                                 make_embedding_masks)
from .clustering import AgglomerativeClustering
from .utils.diarization import SpeakerDiarizationMixin, set_num_speakers


@dataclass
class DiarizeOutput:
    """Diarization, its exclusive variant, and one centroid per speaker."""

    speaker_diarization: Annotation
    exclusive_speaker_diarization: Annotation
    speaker_embeddings: Optional[np.ndarray] = None


class SpeakerDiarization(SpeakerDiarizationMixin, Pipeline):
    """Segmentation + embedding + clustering speaker diarization.

    ``segmentation`` is a PyanNet-like powerset model and ``embedding`` a
    WeSpeakerResNet34-like model (``frames`` / ``embed``); both are moved
    to ``device`` and run in eval mode.
    """

    def __init__(self, segmentation: nn.Module, embedding: nn.Module,
                 segmentation_step: float = 0.1,
                 embedding_exclude_overlap: bool = False,
                 clustering: str = "AgglomerativeClustering",
                 embedding_batch_size: int = 32,
                 segmentation_batch_size: int = 32,
                 device: Union[str, torch.device] = "cpu"):
        if clustering != "AgglomerativeClustering":
            raise ValueError("only AgglomerativeClustering is ported")
        if not segmentation.specifications.powerset:
            raise ValueError("the segmentation model must be powerset")
        self.device = torch.device(device)
        self.segmentation_step = segmentation_step
        self.embedding_exclude_overlap = embedding_exclude_overlap
        self.embedding_batch_size = embedding_batch_size
        self._embedding = embedding.to(self.device).eval()
        segmentation = segmentation.to(self.device).eval()
        duration = segmentation.specifications.duration
        self._segmentation = Inference(
            segmentation, duration=duration,
            step=segmentation_step * duration,
            batch_size=segmentation_batch_size)
        self._audio = Audio(sample_rate=16000)
        self.clustering = AgglomerativeClustering(metric="cosine")

    def default_parameters(self) -> Dict[str, Any]:
        return {"segmentation": {"min_duration_off": 0.0},
                "clustering": {"method": "centroid", "min_cluster_size": 15,
                               "threshold": 0.7}}

    @staticmethod
    def classes() -> Iterator[str]:
        """Infinite SPEAKER_%02d label generator."""
        i = 0
        while True:
            yield f"SPEAKER_{i:02d}"
            i += 1

    # -- stages -------------------------------------------------------------

    @staticmethod
    def _aggregation_grid(chunk_window: SlidingWindow,
                          frames: SlidingWindow, num_chunks: int
                          ) -> Tuple[np.ndarray, int, SlidingWindow]:
        """Per-chunk output-frame offsets, output length and output grid,
        with the op order of SlidingWindow.closest_frame."""
        window = SlidingWindow(start=chunk_window.start,
                               duration=frames.duration, step=frames.step)
        t = chunk_window.start + np.arange(num_chunks) * chunk_window.step
        offsets = np.rint(
            (t + 0.5 * frames.duration - window.start
             - 0.5 * window.duration) / window.step).astype(np.int64)
        num_output_frames = window.closest_frame(
            chunk_window.start + chunk_window.duration
            + (num_chunks - 1) * chunk_window.step
            + 0.5 * frames.duration) + 1
        return offsets, num_output_frames, window

    @torch.inference_mode()
    def get_embeddings(self, waveform: torch.Tensor,
                       binarized: SlidingWindowFeature,
                       exclude_overlap: bool = False) -> np.ndarray:
        """(num_chunks, num_speakers, dimension) embeddings on the host.

        The ResNet trunk runs once per chunk; per-speaker masks drive only
        the statistics pooling.
        """
        scores = binarized.data
        num_chunks, num_frames, _ = scores.shape
        emb = self._embedding
        # smallest input still giving one pooled frame: one fbank window
        # widened by the trunk's 8x time reduction
        window = int(emb.sample_rate * emb.frame_length * 0.001)
        shift = int(emb.sample_rate * emb.frame_shift * 0.001)
        duration = binarized.sliding_window.duration
        min_num_frames = math.ceil(num_frames * (window + 7 * shift)
                                   / (duration * emb.sample_rate))
        masks = make_embedding_masks(scores, exclude_overlap,
                                     min_num_frames)          # (C, S, F)
        chunks = chunk_views(
            waveform, round(duration * emb.sample_rate),
            round(binarized.sliding_window.step * emb.sample_rate))
        B = self.embedding_batch_size
        out = [emb.embed(emb.frames(chunks[b:b + B].contiguous()),
                         masks[b:b + B])
               for b in range(0, num_chunks, B)]
        return torch.cat(out).cpu().numpy()

    # -- apply --------------------------------------------------------------

    @torch.inference_mode()
    def apply(self, file: Dict, num_speakers: Optional[int] = None,
              min_speakers: Optional[int] = None,
              max_speakers: Optional[int] = None) -> DiarizeOutput:
        num_speakers, min_speakers, max_speakers = set_num_speakers(
            num_speakers=num_speakers, min_speakers=min_speakers,
            max_speakers=max_speakers)
        waveform, sample_rate = self._audio(file)
        waveform = torch.from_numpy(waveform).to(self.device)

        segmentations = self._segmentation.slide(waveform, sample_rate)
        scores = segmentations.data                           # (C, F, S)
        num_chunks = scores.shape[0]
        offsets, num_output_frames, window = self._aggregation_grid(
            segmentations.sliding_window,
            self._segmentation.model.receptive_field, num_chunks)
        offsets_dev = torch.from_numpy(offsets).to(self.device)
        count, speaker_frames, clean_frames = fused_count_stats(
            scores, offsets_dev, num_output_frames)
        count = count.cpu().numpy()
        speaker_frames = speaker_frames.cpu().numpy()
        clean_frames = clean_frames.cpu().numpy()

        if np.nanmax(count) == 0:
            # silent file
            return DiarizeOutput(
                Annotation(uri=file["uri"]), Annotation(uri=file["uri"]),
                np.zeros((0, self._embedding.dimension)))

        embeddings = self.get_embeddings(
            waveform, segmentations,
            exclude_overlap=self.embedding_exclude_overlap)
        hard_clusters, _, centroids = self.clustering(
            embeddings, clean_frames, num_frames=scores.shape[1],
            num_clusters=num_speakers, min_clusters=min_speakers,
            max_clusters=max_speakers)

        num_different_speakers = int(np.max(hard_clusters)) + 1
        if num_different_speakers < min_speakers or \
                num_different_speakers > max_speakers:
            warnings.warn(textwrap.dedent(
                f"""
                The detected number of speakers ({num_different_speakers})
                for {file['uri']} is outside the given bounds
                [{min_speakers}, {max_speakers}]. The audio file may be too
                short for {min_speakers} speakers.
                """))

        cnt = np.minimum(count, max_speakers).astype(np.int8).reshape(-1)
        hard_clusters = np.asarray(hard_clusters, dtype=np.int64)
        hard_clusters[speaker_frames == 0] = -2             # inactive
        num_clusters = max(int(hard_clusters.max()) + 1,
                           int(cnt.max()) if len(cnt) else 0, 1)
        binary, exclusive = fused_reconstruct(
            scores, torch.from_numpy(hard_clusters).to(self.device),
            offsets_dev, torch.from_numpy(cnt).to(self.device),
            num_clusters, num_output_frames)

        min_duration_off = self.segmentation.min_duration_off
        diarization, exclusive_diarization = (
            self.to_annotation(
                SlidingWindowFeature(b.cpu().numpy().astype(np.float32),
                                     window),
                min_duration_off=min_duration_off)
            for b in (binary, exclusive))

        mapping = {label: expected for label, expected in
                   zip(diarization.labels(), self.classes())}
        diarization = diarization.rename_labels(mapping)
        exclusive_diarization = exclusive_diarization.rename_labels(mapping)
        diarization.uri = exclusive_diarization.uri = file["uri"]

        labels = diarization.labels()
        if len(labels) > centroids.shape[0]:
            centroids = np.pad(
                centroids, ((0, len(labels) - centroids.shape[0]), (0, 0)))
        inverse_mapping = {label: index for index, label in mapping.items()}
        centroids = centroids[[inverse_mapping[label] for label in labels]]
        return DiarizeOutput(diarization, exclusive_diarization, centroids)
