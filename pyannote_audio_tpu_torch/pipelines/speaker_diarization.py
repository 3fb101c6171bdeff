"""Speaker diarization pipeline.

Counterpart of pyannote_audio_tpu/pipelines/speaker_diarization.py:
sliding-window segmentation -> speaker count and activity statistics ->
one embedding per (chunk, speaker), the ResNet trunk's frames shared by a
chunk's speakers and speaker masks acting only at pooling -> host
clustering -> count-constrained reconstruction -> Annotation.

The embedding stage takes one of the JAX package's three paths:

- shared trunk (gate PYANNOTE_TPU_SHARED_TRUNK, by default on a CUDA
  device, off on the CPU): one whole-file fbank, a sliding-window CMN, the
  trunk once over the file in halo'd panels, then each chunk pools its
  slice of the trunk frames. It is approximate by design (the CMN and the
  real context at chunk borders differ from a standalone chunk's), and
  it is queued right after segmentation, before the first host sync;
- shared fbank (on every device): one whole-file fbank sliced per chunk,
  the mean subtracted per chunk, the trunk per chunk. Exact;
- per chunk: fbank and trunk per chunk, the reference semantics.

The two shared paths need chunk starts on the 160-sample fbank shift.
Everything up to the embeddings stays on ``device``; clustering runs on
the host, then reconstruction runs on the device again. Files are
processed one after another. Not ported yet: bounded-memory long files,
pipelined batches on CUDA streams, hooks, VBx/KMeans/oracle clustering,
and renaming labels after a reference annotation (labels are always
SPEAKER_00, ...).
"""

from __future__ import annotations

import math
import textwrap
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.annotation import Annotation
from ..core.inference import (Inference, _chunk_grid, chunk_views,
                              pad_to_grid)
from ..core.io import Audio
from ..core.pipeline import Pipeline
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..ops.diarize_fused import (fused_count_stats, fused_reconstruct,
                                 make_embedding_masks)
from ..ops.fbank import fbank_num_frames, whole_fbank
from ..utils.runtime import device_flag
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
    WeSpeakerResNet34-like model (``frames`` / ``frames_from_fbank`` /
    ``embed``); both are moved to ``device`` and run in eval mode.
    ``device`` is the CUDA card by default; without one the constructor
    raises, and ``device="cpu"`` runs the exact path on the CPU.
    ``counts`` records which embedding path ran (reset it at will).
    """

    # shared-trunk panel geometry, in trunk frames: halo * stride fbank
    # frames of context on each side cover the trunk's receptive field, so
    # a panel's core equals the whole-file trunk there
    TRUNK_PANEL_CORE = 512
    TRUNK_PANEL_HALO = 64
    TRUNK_PANEL_BATCH = 8

    def __init__(self, segmentation: nn.Module, embedding: nn.Module,
                 segmentation_step: float = 0.1,
                 embedding_exclude_overlap: bool = False,
                 clustering: str = "AgglomerativeClustering",
                 embedding_batch_size: int = 32,
                 segmentation_batch_size: int = 32,
                 device: Union[str, torch.device] = "cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("SpeakerDiarization runs on a CUDA device by "
                               "default and none is available: pass "
                               "device=\"cpu\" to run on the CPU")
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
        self.counts = {"whole_fbank": 0, "trunk_panel_batches": 0,
                       "chunk_trunk_batches": 0}

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

    # -- embeddings ---------------------------------------------------------

    def _frame_shift_samples(self) -> int:
        emb = self._embedding
        return int(emb.sample_rate * emb.frame_shift * 0.001)

    def _shared_fbank(self, step_samples: int) -> bool:
        """Slice one whole-file fbank per chunk? Exact when chunk starts
        lie on the fbank frame shift."""
        shift = self._frame_shift_samples()
        return shift > 0 and step_samples % shift == 0

    def _shared_trunk(self, step_samples: int, device: torch.device) -> bool:
        return self._shared_fbank(step_samples) and \
            device_flag("PYANNOTE_TPU_SHARED_TRUNK", device)

    def _whole_fbank(self, padded: torch.Tensor) -> torch.Tensor:
        emb = self._embedding
        self.counts["whole_fbank"] += 1
        return whole_fbank(padded, num_mel_bins=emb.num_mel_bins,
                           sample_rate=emb.sample_rate,
                           frame_length=emb.frame_length,
                           frame_shift=emb.frame_shift,
                           window_type=emb.window_type)

    def _fbank_frames_per_chunk(self, window_samples: int) -> int:
        emb = self._embedding
        return fbank_num_frames(window_samples, emb.sample_rate,
                                emb.frame_length, emb.frame_shift)

    def trunk_geometry(self, window_samples: int) -> Dict[str, int]:
        """Fbank and trunk frames per chunk, and the trunk's time stride,
        derived from the trunk's shapes."""
        resnet = self._embedding.resnet
        frames = self._fbank_frames_per_chunk(window_samples)
        trunk_frames = resnet.num_frames(frames)
        stride = 80 // max(1, resnet.num_frames(frames + 80) - trunk_frames)
        return {"frames_per_chunk": frames,
                "trunk_frames_per_chunk": trunk_frames, "stride": stride}

    def _num_panel_batches(self, num_fbank_frames: int, stride: int) -> int:
        trunk_total = -(-num_fbank_frames // stride)
        num_panels = -(-trunk_total // self.TRUNK_PANEL_CORE)
        return -(-num_panels // self.TRUNK_PANEL_BATCH)

    def prepare(self, feats: torch.Tensor, num_real: int,
                window_samples: int) -> torch.Tensor:
        """Sliding-window CMN + halo and tail padding of a (T, mel)
        whole-file fbank.

        Each frame is centered by the mean over a chunk-length window
        around it, clipped to the ``num_real`` frames of real audio (kaldi
        apply-cmvn-sliding, center=true); frames past ``num_real`` become
        0. The result is zero-padded by ``halo * stride`` frames in front
        and up to whole panel batches behind.
        """
        geometry = self.trunk_geometry(window_samples)
        stride = geometry["stride"]
        T = feats.shape[0]
        idx = torch.arange(T, device=feats.device)
        mask = (idx < num_real)[:, None]
        # float64 running sums (a float32 one over an hour of frames loses
        # ~1e-3 of the window means to rounding), along the innermost
        # axis of a (mel, T) copy: a scan along the outer axis of (T, mel)
        # takes a CUDA thread per column through all T frames
        csum = F.pad(torch.cumsum(torch.where(mask, feats, 0.0).T.to(
            torch.float64, memory_format=torch.contiguous_format), dim=1),
            (1, 0))                                         # (mel, T + 1)
        half = geometry["frames_per_chunk"] // 2
        lo = torch.clamp(idx - half, min=0)
        hi = torch.clamp(idx + half, max=max(num_real, 1))
        hi = torch.maximum(hi, lo + 1)
        mean = ((csum[:, hi] - csum[:, lo]) / (hi - lo)).T.to(feats.dtype)
        centered = (feats - mean) * mask
        halo = self.TRUNK_PANEL_HALO * stride
        total = (self._num_panel_batches(T, stride) * self.TRUNK_PANEL_BATCH
                 * self.TRUNK_PANEL_CORE) * stride + 2 * halo
        return F.pad(centered, (0, 0, halo, total - halo - T))

    def compute_trunk(self, padded: torch.Tensor, num_real_frames: int,
                      window_samples: int) -> torch.Tensor:
        """The whole-file trunk of a (1, samples) grid-padded waveform:
        (>= ceil(T / stride), D) trunk frames, in panel batches."""
        stride = self.trunk_geometry(window_samples)["stride"]
        core, halo = self.TRUNK_PANEL_CORE, self.TRUNK_PANEL_HALO
        pbatch = self.TRUNK_PANEL_BATCH
        feats = self._whole_fbank(padded)
        x = self.prepare(feats, num_real_frames, window_samples)
        # (panels, mel, (core + 2 halo) * stride) views, one per core
        panels = x.unfold(0, (core + 2 * halo) * stride, core * stride)
        parts = []
        for b in range(0, panels.shape[0], pbatch):
            out = self._embedding.frames_from_fbank(
                panels[b:b + pbatch].transpose(1, 2), centered=True)
            parts.append(out[:, halo:halo + core])
            self.counts["trunk_panel_batches"] += 1
        trunk = torch.cat(parts) if len(parts) > 1 else parts[0]
        return trunk.reshape(-1, trunk.shape[-1])

    def _whole_trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        """``compute_trunk`` of a (1, samples) waveform on the
        segmentation's chunk grid."""
        emb = self._embedding
        window_samples = round(self._segmentation.duration * emb.sample_rate)
        step_samples = round(self._segmentation.step * emb.sample_rate)
        num_real_frames = fbank_num_frames(
            waveform.shape[1], emb.sample_rate, emb.frame_length,
            emb.frame_shift)
        return self.compute_trunk(
            pad_to_grid(waveform, window_samples, step_samples),
            num_real_frames, window_samples)

    def _start_shared_trunk(self, waveform: torch.Tensor
                            ) -> Optional[torch.Tensor]:
        """Queue the whole-file trunk on the device, or None off the
        shared-trunk path. It depends on the waveform only, so it can run
        before the segmentation scores reach the host."""
        step_samples = round(self._segmentation.step
                             * self._embedding.sample_rate)
        if not self._shared_trunk(step_samples, waveform.device):
            return None
        return self._whole_trunk(waveform)

    @torch.inference_mode()
    def get_embeddings(self, waveform: torch.Tensor,
                       binarized: SlidingWindowFeature,
                       exclude_overlap: bool = False,
                       trunk: Optional[torch.Tensor] = None) -> np.ndarray:
        """(num_chunks, num_speakers, dimension) embeddings on the host.

        ``trunk`` is the whole-file trunk queued by ``_start_shared_trunk``
        (computed here when it is None on the shared-trunk path).
        """
        scores = binarized.data
        num_chunks, num_frames, _ = scores.shape
        emb = self._embedding
        # smallest input still giving one pooled frame: one fbank window
        # widened by the trunk's 8x time reduction
        window = int(emb.sample_rate * emb.frame_length * 0.001)
        shift = self._frame_shift_samples()
        duration = binarized.sliding_window.duration
        min_num_frames = math.ceil(num_frames * (window + 7 * shift)
                                   / (duration * emb.sample_rate))
        masks = make_embedding_masks(scores, exclude_overlap,
                                     min_num_frames)          # (C, S, F)
        window_samples = round(duration * emb.sample_rate)
        step_samples = round(binarized.sliding_window.step * emb.sample_rate)
        starts, _ = _chunk_grid(waveform.shape[1], window_samples,
                                step_samples)
        assert len(starts) == num_chunks
        padded = pad_to_grid(waveform, window_samples, step_samples)
        device = waveform.device
        B = self.embedding_batch_size

        if self._shared_trunk(step_samples, device):
            if trunk is None:
                trunk = self._whole_trunk(waveform)
            geometry = self.trunk_geometry(window_samples)
            first = torch.from_numpy(
                starts // shift // geometry["stride"]).to(device)
            offsets = torch.arange(geometry["trunk_frames_per_chunk"],
                                   device=device)

            def batch(b):
                frames = trunk[first[b:b + B, None] + offsets]
                return emb.embed(frames, masks[b:b + B])
        elif self._shared_fbank(step_samples):
            feats = self._whole_fbank(padded)
            first = torch.from_numpy(starts // shift).to(device)
            offsets = torch.arange(
                self._fbank_frames_per_chunk(window_samples), device=device)

            def batch(b):
                self.counts["chunk_trunk_batches"] += 1
                chunk_feats = feats[first[b:b + B, None] + offsets]
                return emb.embed(emb.frames_from_fbank(chunk_feats),
                                 masks[b:b + B])
        else:
            chunks = chunk_views(padded, window_samples, step_samples)

            def batch(b):
                self.counts["chunk_trunk_batches"] += 1
                return emb.embed(emb.frames(chunks[b:b + B].contiguous()),
                                 masks[b:b + B])

        out = [batch(b) for b in range(0, num_chunks, B)]
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
        # queued behind segmentation, before the count's host sync
        trunk = self._start_shared_trunk(waveform)
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
            exclude_overlap=self.embedding_exclude_overlap, trunk=trunk)
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
