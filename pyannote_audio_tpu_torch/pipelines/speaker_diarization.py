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

The two shared paths need chunk starts on the 160-sample fbank shift
and a model with ``frames_from_fbank`` (the WeSpeaker family); any other
embedder (the x-vectors) takes the per-chunk path, in batches, on
long-file slices too, and its minimum speech comes from
``speaker_verification.analytic_min_num_samples``.

With ``training`` set (the CLI's ``optimize``), a file dict keeps its
segmentation under ``training_cache/segmentation`` and its embeddings
under ``training_cache/embeddings`` (the latter keyed on
``segmentation.threshold`` for a non-powerset model), so a second pass
over the same dict with other clustering or post-processing
hyperparameters runs neither model; the shared trunk is not started
early, as in the JAX package. Both caches hold device tensors.

``apply`` is ``_finalize(_stage(file))``. ``_stage`` queues a file's whole
device program (segmentation, the early shared trunk, count and
statistics, masks and embeddings) and starts the copies of its small
results into page-locked host memory, with no host sync; ``_finalize``
waits for them, clusters on the host, reconstructs on the device and
builds the Annotations. ``apply_batch`` stages up to ``stage_ahead``
files ahead of the one it finalizes while worker threads decode the next
ones, so host work overlaps the device's. Files past the device-memory
budget run in halo'd slices (core/longfile.py). Hooks see every stage,
under the JAX package's step names.

With a ``mesh`` (``parallel/mesh.py``) the segmentation ``Inference``
splits its batches over the mesh's devices, and so do the embedding
batches and the shared trunk's panel batches: each device runs its own
replica of the embedding model, shards move with ``non_blocking=True``
and outputs concatenate on the first device, which is the pipeline's
device. ``embedding_batch_size`` rounds up to a multiple of the mesh's
size, as in the JAX package.

The constructor takes the JAX package's surface: models as instances,
local checkpoint paths or ``{checkpoint, subfolder}`` dicts (which is what
``Pipeline.from_pretrained`` passes for a community-1 style snapshot),
a PLDA for ``clustering="VBxClustering"`` and any ``Clustering`` member.
Clusterings that expect a speaker count take it from
``file["annotation"]`` when the caller gives none; oracle clustering
without an embedding model skips the embedding program. Labels follow
``file["annotation"]`` when a file carries one (Hungarian mapping, the
centroids reordered to match), else SPEAKER_00, ...

A non-powerset (multi-label, sigmoid) segmentation model's scores are
binarized at ``segmentation.threshold`` with the initial state off, as
the JAX package's ``binarize_swf`` does on the host; here the hysteresis
runs on the device (``ops/binarize.py``), so the file stays on the
zero-sync ``_stage`` path. The binarized scores drive the count, the
embedding masks and oracle clustering; the soft scores drive the
reconstruction.
"""

from __future__ import annotations

import functools
import itertools
import math
import textwrap
import threading
import warnings
from collections import deque
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from ..core.annotation import Annotation
from ..core.inference import (Inference, _chunk_grid,
                              _upload_waveform_cached, chunks_at,
                              pad_to_grid, to_device)
from ..core.io import Audio
from ..core.longfile import Slice, plan_slices, slice_uploads
from ..core.parameter import ParamDict, Uniform
from ..core.pipeline import Pipeline, _evict, check_device
from ..core.segment import SlidingWindow, SlidingWindowFeature
from ..metrics.der import GreedyDiarizationErrorRate
from ..ops import fbank as fbank_ops
from ..ops.binarize import hysteresis
from ..ops.diarize_fused import (fused_count_stats, fused_reconstruct,
                                 make_embedding_masks)
from ..ops.fbank import fbank_num_frames, whole_fbank
from ..parallel.mesh import Mesh, map_shards, replicate
from ..telemetry.spans import device_mark, device_unit, span
from ..utils.runtime import device_flag
from .clustering import Clustering, OracleClustering
from .speaker_verification import analytic_min_num_samples
from .utils.diarization import SpeakerDiarizationMixin, set_num_speakers
from .utils.getter import PipelineModel, get_model, get_plda


def batchify(iterable, batch_size: int = 32, fillvalue=None):
    """Tuples of ``batch_size`` items, the last padded with
    ``fillvalue``: batchify("ABCDEFG", 3) -> ("A", "B", "C"),
    ("D", "E", "F"), ("G", None, None)."""
    args = [iter(iterable)] * batch_size
    return itertools.zip_longest(*args, fillvalue=fillvalue)


@dataclass
class DiarizeOutput:
    """Diarization, its exclusive variant, and one centroid per speaker."""

    speaker_diarization: Annotation
    exclusive_speaker_diarization: Annotation
    speaker_embeddings: Optional[np.ndarray] = None

    def serialize(self) -> Dict[str, Any]:
        """The turns of both annotations as JSON-ready dicts (times
        rounded to the millisecond), as the JAX package serializes them."""
        def turns(annotation: Annotation):
            return [{"start": round(segment.start, 3),
                     "end": round(segment.end, 3), "speaker": label}
                    for segment, _, label in
                    annotation.itertracks(yield_label=True)]
        return {"diarization": turns(self.speaker_diarization),
                "exclusive_diarization":
                    turns(self.exclusive_speaker_diarization)}


class EmbeddingMixin:
    """One embedding per (chunk, speaker) on the pipeline's device, by one
    of the three paths (shared trunk, shared fbank, per chunk): the
    counterpart of the JAX package's ``EmbeddingHotPathMixin``. A host
    class has ``_embedding``, ``_segmentation`` (an ``Inference``),
    ``device``, ``embedding_batch_size`` and the path ``counts``, and
    may have a ``mesh``; it calls ``_replicate_embedding`` once it has
    its embedding model."""

    # shared-trunk panel geometry, in trunk frames: halo * stride fbank
    # frames of context on each side cover the trunk's receptive field, so
    # a panel's core equals the whole-file trunk there
    TRUNK_PANEL_CORE = 512
    TRUNK_PANEL_HALO = 64
    TRUNK_PANEL_BATCH = 8
    # file-dict key of the training cache, as in the JAX package
    CACHED_EMBEDDINGS = "training_cache/embeddings"

    def _replicate_embedding(self) -> None:
        """The embedding model's mesh (the pipeline's, else its device
        alone) and one replica of the model per device of it."""
        self._embedding_mesh = getattr(self, "mesh", None) \
            or Mesh([self.device])
        self._embedding_replicas = None if self._embedding is None \
            else replicate(self._embedding, self._embedding_mesh)

    def to(self, device: Union[str, torch.device]):
        """The pipeline's ``to``, then the embedding replicas afresh."""
        super().to(device)
        self._replicate_embedding()
        return self

    def _embed_sharded(self, fn: Callable, *args):
        """``fn(embedding replica, *shard)`` on each device's shard of
        ``args``' leading axis, gathered on the pipeline's device."""
        return map_shards(self._embedding_mesh, self._embedding_replicas,
                          fn, *args)

    def _frame_shift_samples(self) -> int:
        emb = self._embedding
        return int(emb.sample_rate * emb.frame_shift * 0.001)

    def _shared_fbank(self, step_samples: int) -> bool:
        """Slice one whole-file fbank per chunk? Only for a model with
        ``frames_from_fbank`` (the WeSpeaker family), and exact when chunk
        starts lie on the fbank frame shift."""
        if not hasattr(self._embedding, "frames_from_fbank"):
            return False
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

        def panel_cores(emb, batch):
            self.counts["trunk_panel_batches"] += 1
            return emb.frames_from_fbank(batch.transpose(1, 2),
                                         centered=True)[:, halo:halo + core]
        parts = [self._embed_sharded(panel_cores, panels[b:b + pbatch])
                 for b in range(0, panels.shape[0], pbatch)]
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

    def _plan(self, num_samples: int) -> Optional[List[Slice]]:
        """The file's slice plan (core/longfile.py) on the segmentation's
        chunk grid, or None when it takes whole-file buffers."""
        sample_rate = self._segmentation.model.sample_rate
        window_samples = round(self._segmentation.duration * sample_rate)
        step_samples = round(self._segmentation.step * sample_rate)
        starts, _ = _chunk_grid(num_samples, window_samples, step_samples)
        plan = plan_slices(num_samples, window_samples, step_samples,
                           sample_rate, starts)
        return plan if plan is not None and len(plan) > 1 else None

    def _start_shared_trunk(self, waveform) -> Optional[torch.Tensor]:
        """Queue the whole-file trunk of a (1, samples) waveform on the
        device, or None off the shared-trunk path and for a file that runs
        in slices (``get_embeddings`` then runs a trunk per slice). It
        depends on the waveform only, so it can run before the
        segmentation scores reach the host."""
        step_samples = round(self._segmentation.step
                             * self._embedding.sample_rate)
        if not self._shared_trunk(step_samples, self.device) or \
                self._plan(waveform.shape[1]) is not None:
            return None
        return self._whole_trunk(_upload_waveform_cached(waveform, None,
                                                         self.device))

    @torch.inference_mode()
    def get_embeddings(self, waveform, binarized: SlidingWindowFeature,
                       exclude_overlap: bool = False,
                       trunk: Optional[torch.Tensor] = None,
                       hook: Optional[Callable] = None, cache=None,
                       defer_fetch: bool = False):
        """(num_chunks, num_speakers, dimension) embeddings.

        ``waveform`` is the file's (1, samples) float32 host array,
        uploaded through ``cache`` (the file dict), or a tensor on the
        device. ``trunk`` is the whole-file trunk queued by
        ``_start_shared_trunk`` (computed here when it is None on the
        shared-trunk path). A file past the memory budget runs in slices:
        each slice's front-end (trunk, fbank or chunks) is computed from
        its own upload and released after its batches. Returns a host
        array, or the device tensor with ``defer_fetch``; in training the
        device tensor is also kept in ``cache`` (the file dict) under
        ``training_cache/embeddings`` and returned from there while it is
        valid. ``hook`` gets ``("embeddings", None,
        total=batches, completed=...)`` before the first batch and after
        each.
        """
        if self.training:
            cached = self._cached_embeddings(cache)
            if cached is not None:
                return cached if defer_fetch else cached.cpu().numpy()
        scores = binarized.data
        num_chunks, num_frames, _ = scores.shape
        emb = self._embedding
        duration = binarized.sliding_window.duration
        # the model's smallest input that still gives one pooled frame
        min_num_frames = math.ceil(num_frames * analytic_min_num_samples(emb)
                                   / (duration * emb.sample_rate))
        masks = make_embedding_masks(scores, exclude_overlap,
                                     min_num_frames)          # (C, S, F)
        window_samples = round(duration * emb.sample_rate)
        step_samples = round(binarized.sliding_window.step * emb.sample_rate)
        num_samples = waveform.shape[1]
        starts, _ = _chunk_grid(num_samples, window_samples, step_samples)
        assert len(starts) == num_chunks
        device = self.device
        B = self.embedding_batch_size

        shared_trunk = self._shared_trunk(step_samples, device)
        if shared_trunk:
            geometry = self.trunk_geometry(window_samples)
            stride = geometry["stride"]
            width = geometry["trunk_frames_per_chunk"]
            shift = self._frame_shift_samples()

            def input_for(buffer, num_real_samples):
                return self.compute_trunk(buffer, fbank_num_frames(
                    num_real_samples, emb.sample_rate, emb.frame_length,
                    emb.frame_shift), window_samples)

            def translate(chunk_starts):
                return chunk_starts // shift // stride

            def batch(model, frames, masks):
                return model.embed(frames, masks)
        elif self._shared_fbank(step_samples):
            width = self._fbank_frames_per_chunk(window_samples)
            shift = self._frame_shift_samples()

            def input_for(buffer, num_real_samples):
                return self._whole_fbank(buffer)

            def translate(chunk_starts):
                return chunk_starts // shift

            def batch(model, feats, masks):
                self.counts["chunk_trunk_batches"] += 1
                return model.embed(model.frames_from_fbank(feats), masks)
        else:
            translate = None

            def input_for(buffer, num_real_samples):
                return buffer

            def batch(model, chunks, masks):
                self.counts["chunk_trunk_batches"] += 1
                return model.embed(model.frames(chunks.contiguous()), masks)

        # groups of (input thunk, slice-local chunk starts, first global
        # chunk): one for the whole file, or one per slice of a long
        # file; masks are indexed by global chunk either way
        plan = self._plan(num_samples)
        if plan is None:
            def whole_input():
                if trunk is not None and shared_trunk:
                    return trunk
                return input_for(pad_to_grid(
                    _upload_waveform_cached(waveform, cache, device),
                    window_samples, step_samples), num_samples)
            groups = [(whole_input, starts, 0)]
            release_upload = None
        else:
            get_upload, release_upload = slice_uploads(
                cache, waveform, plan, emb.sample_rate, starts,
                window_samples, device)

            def slice_group(k):
                sl = plan[k]

                def make_input():
                    buffer = get_upload(k)
                    return input_for(buffer, min(sl.b - sl.a,
                                                 buffer.shape[1]))
                return make_input, starts[sl.i0:sl.i1] - sl.a, sl.i0
            groups = [slice_group(k) for k in range(len(plan))]

        num_batches = sum(math.ceil(len(g[1]) / B) for g in groups)
        if hook is not None:
            hook("embeddings", None, total=num_batches, completed=0)
        out = []
        for gi, (make_input, group_starts, chunk0) in enumerate(groups):
            source = make_input()
            if translate is None:
                views = chunks_at(source, group_starts, window_samples)
            else:
                first = to_device(translate(group_starts), device)
                offsets = torch.arange(width, device=device)
            for b in range(0, len(group_starts), B):
                e = min(b + B, len(group_starts))
                if translate is None:
                    inputs = views[b:e]
                else:
                    inputs = source[first[b:e, None] + offsets]
                out.append(self._embed_sharded(
                    batch, inputs, masks[chunk0 + b:chunk0 + e]))
                if hook is not None:
                    hook("embeddings", None, total=num_batches,
                         completed=len(out))
            if release_upload is not None:
                # the queued work holds its buffers until it has run
                release_upload(gi)
        embeddings = torch.cat(out) if len(out) > 1 else out[0]
        if self.training and cache is not None:
            entry = {"embeddings": embeddings}
            if not getattr(self, "_powerset", False):
                entry["segmentation.threshold"] = self.segmentation.threshold
            cache[self.CACHED_EMBEDDINGS] = entry
        return embeddings if defer_fetch else embeddings.cpu().numpy()

    def _cached_embeddings(self, file) -> Optional[torch.Tensor]:
        """The embeddings cached in a file dict in training, if they are
        still valid (a non-powerset model's depend on its binarization
        threshold)."""
        entry = file.get(self.CACHED_EMBEDDINGS) \
            if isinstance(file, Mapping) else None
        if not entry or "embeddings" not in entry:
            return None
        if getattr(self, "_powerset", False) or \
                entry.get("segmentation.threshold") == \
                self.segmentation.threshold:
            return entry["embeddings"]
        return None


class SpeakerDiarization(SpeakerDiarizationMixin, EmbeddingMixin,
                         Pipeline):
    """Segmentation + embedding + clustering speaker diarization.

    ``segmentation`` is a PyanNet-like model (powerset, or multi-label
    with a sigmoid head) and ``embedding`` any model with ``frames`` and
    ``embed`` (every WeSpeaker depth, which also has
    ``frames_from_fbank`` for the shared paths, or an x-vector, which
    takes the per-chunk path), each an instance, a local checkpoint path or a
    ``{checkpoint, subfolder}`` dict; both are moved to ``device`` and run
    in eval mode. ``embedding`` may be None only for oracle clustering.
    ``plda`` (an instance, a directory or such a dict) serves
    ``clustering="VBxClustering"``. A model or PLDA may also be a hub id
    (``utils/hf_hub.py``, with ``token`` and ``cache_dir``). ``device``
    is the CUDA card by default; without one the constructor raises, and
    ``device="cpu"`` runs the exact path on the CPU; ``to(device)`` moves
    the pipeline later. ``mesh`` (``parallel.make_mesh``) splits the
    segmentation, embedding and trunk-panel batches over its devices;
    ``device`` must be the mesh's first, and ``to`` takes no other.
    ``legacy`` returns only the diarization ``Annotation``. ``counts``
    records which embedding path ran, one count per batch and mesh shard
    (reset it at will).
    """

    # apply_batch streams its own decode
    STREAMS_DECODE = True
    # file-dict key of the training cache, as in the JAX package
    CACHED_SEGMENTATION = "training_cache/segmentation"

    def __init__(self, segmentation: PipelineModel = None,
                 embedding: Optional[PipelineModel] = None,
                 segmentation_step: float = 0.1,
                 embedding_exclude_overlap: bool = False,
                 plda=None,
                 clustering: str = "AgglomerativeClustering",
                 embedding_batch_size: int = 32,
                 segmentation_batch_size: int = 32,
                 der_variant: Optional[dict] = None,
                 legacy: bool = False,
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, token=None, cache_dir=None):
        super().__init__()
        self.mesh = mesh
        if mesh is not None:
            mesh.check_first(device)
            embedding_batch_size = -(-embedding_batch_size // mesh.size) \
                * mesh.size
        self.device = check_device(device)
        try:
            Klustering = Clustering[clustering].value
        except KeyError:
            raise ValueError(f"clustering must be one of "
                             f"{[member.name for member in Clustering]}")
        if segmentation is None:
            raise ValueError("a segmentation model is required")
        hub = dict(token=token, cache_dir=cache_dir)
        segmentation = get_model(segmentation, **hub)
        if embedding is None and Klustering is not OracleClustering:
            raise ValueError(f"{clustering} needs an embedding model")
        self._powerset = segmentation.specifications.powerset
        self.legacy = legacy
        self.segmentation_step = segmentation_step
        self.embedding_exclude_overlap = embedding_exclude_overlap
        self.embedding_batch_size = embedding_batch_size
        self.klustering = clustering
        self.der_variant = der_variant or {"collar": 0.0,
                                           "skip_overlap": False}
        self._embedding = get_model(embedding, **hub).to(self.device).eval() \
            if embedding is not None else None
        segmentation = segmentation.to(self.device).eval()
        duration = segmentation.specifications.duration
        self._segmentation = Inference(
            segmentation, duration=duration,
            step=segmentation_step * duration, skip_aggregation=True,
            batch_size=segmentation_batch_size, device=self.device,
            mesh=mesh)
        self._replicate_embedding()
        if self._powerset:
            self.segmentation = ParamDict(min_duration_off=Uniform(0.0, 1.0))
        else:
            self.segmentation = ParamDict(threshold=Uniform(0.1, 0.9),
                                          min_duration_off=Uniform(0.0, 1.0))
        self._audio = Audio(sample_rate=16000)
        if Klustering is OracleClustering:
            self.clustering = OracleClustering()
        elif clustering == "VBxClustering":
            self.clustering = Klustering(plda=get_plda(plda, **hub),
                                         metric="cosine")
        else:
            self.clustering = Klustering(metric="cosine")
        self.clustering.to(self.device)
        self._expects_num_speakers = self.clustering.expects_num_clusters
        self.counts = {"whole_fbank": 0, "trunk_panel_batches": 0,
                       "chunk_trunk_batches": 0}

    def default_parameters(self) -> Dict[str, Any]:
        """The JAX package's defaults; a non-powerset model has none
        (except with VBx), so it must be instantiated first."""
        if self.klustering == "VBxClustering":
            return {"segmentation": {"min_duration_off": 0.0},
                    "clustering": {"threshold": 0.6, "Fa": 0.07, "Fb": 0.8}}
        if not self._powerset:
            raise NotImplementedError
        return {"segmentation": {"min_duration_off": 0.0},
                "clustering": {"method": "centroid", "min_cluster_size": 15,
                               "threshold": 0.7}}

    def to(self, device: Union[str, torch.device]) -> "SpeakerDiarization":
        """Move the models, the segmentation ``Inference`` and the
        clustering's device to ``device``, dropping what was cached for
        the old one (the powerset mapping, the LSTM's packed weights, the
        fbank's constants). Under a mesh ``device`` must be the mesh's
        first device; the replicas on the others are copied afresh."""
        if self.mesh is not None:
            self.mesh.check_first(device)
        super().to(device)
        fbank_ops._constant.cache_clear()
        return self

    def get_metric(self) -> GreedyDiarizationErrorRate:
        return GreedyDiarizationErrorRate(**self.der_variant)

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

    # -- apply --------------------------------------------------------------

    def warmup(self, duration: float = 600.0, **kwargs) -> None:
        """Run one synthetic ``duration``-second file through ``__call__``
        (the JAX package's recipe: noise and a harmonic voice every 7 s,
        loud enough that trained models find speakers), so that the
        kernel build, cuDNN's plans and the embedding, clustering and
        reconstruction paths are warm before serving. ``kwargs`` go to
        ``apply`` (for example ``max_speakers``)."""
        sr = self._audio.sample_rate
        n = int(duration * sr)
        rng = np.random.default_rng(0)
        t = np.arange(n) / sr
        waveform = 0.003 * rng.standard_normal(n).astype(np.float32)
        seg_len = 5.0
        for i, start in enumerate(
                np.arange(0.0, max(duration - seg_len, 0.0), 7.0)):
            f0 = [140.0, 210.0, 320.0][i % 3]
            i0, i1 = int(start * sr), int((start + seg_len) * sr)
            tt = t[i0:i1]
            waveform[i0:i1] += (
                0.2 * np.sin(2 * np.pi * f0 * tt)
                * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3 * tt)))
            ).astype(np.float32)
        self({"waveform": waveform[None], "sample_rate": sr,
              "uri": "__warmup__"}, **kwargs)

    def get_segmentations(self, file, hook: Optional[Callable] = None,
                          source=None, sample_rate: Optional[int] = None
                          ) -> SlidingWindowFeature:
        """The file's (chunks, frames, classes) segmentation scores on the
        device. ``source`` is its uploaded waveform, or its host waveform
        for a file that runs in slices (decoded and uploaded here when
        None). In training the result is cached in the file dict."""
        if self.training and self.CACHED_SEGMENTATION in file:
            return file[self.CACHED_SEGMENTATION]
        if source is None:
            waveform, sample_rate = self._audio(file)
            source = self._source(waveform, file)
        segmentations = self._segmentation.slide(
            source, sample_rate, cache=file,
            hook=None if hook is None
            else functools.partial(hook, "segmentation", None))
        if self.training:
            file[self.CACHED_SEGMENTATION] = segmentations
        return segmentations

    def _source(self, waveform: np.ndarray, file) -> Any:
        """A whole file is uploaded once and shared by the stages; a long
        file's slices are uploaded by the stages themselves."""
        if self._plan(waveform.shape[1]) is not None:
            return waveform
        return _upload_waveform_cached(waveform, file, self.device)

    def preload(self, file) -> None:
        """Start a file's upload early (the segmentation's
        ``Inference.preload``: the whole waveform, or a long file's first
        slice). ``apply_batch`` orders its uploads itself; this serves the
        generic batch path and callers that want to warm a file."""
        self._segmentation.preload(file)

    def _fetch_async(self, tensors: Dict[str, torch.Tensor],
                     timing: bool = False):
        """Start the device -> host copies of ``tensors`` into page-locked
        host tensors and record an event after them (timing-enabled with
        ``timing``); on the CPU the tensors are the host tensors and there
        is no event."""
        if self.device.type != "cuda":
            return dict(tensors), None
        host = {}
        for name, tensor in tensors.items():
            host[name] = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            host[name].copy_(tensor, non_blocking=True)
        event = torch.cuda.Event(enable_timing=timing)
        event.record()
        return host, event

    @torch.inference_mode()
    def _stage(self, file: Dict, num_speakers: Optional[int] = None,
               min_speakers: Optional[int] = None,
               max_speakers: Optional[int] = None,
               hook: Optional[Callable] = None, **kwargs) -> Dict[str, Any]:
        """Queue a file's device program without a host sync.

        Segmentation, the early shared trunk, the fused count and
        statistics, the pooling masks and the embeddings are queued on the
        current stream, then the copies of the count, the statistics and
        the embeddings into page-locked host memory and an event after
        them. ``_finalize`` does the host half. Spans: ``stage``, with
        ``segmentation`` and ``embedding`` inside; while recording on the
        card, the queued work is the file's ``stage`` device unit.
        """
        with span("stage", file):
            if kwargs:
                warnings.warn(f"Ignoring unexpected keyword arguments: "
                              f"{', '.join(kwargs)}")
            hook = self.setup_hook(file, hook=hook)
            num_speakers, min_speakers, max_speakers = set_num_speakers(
                num_speakers=num_speakers, min_speakers=min_speakers,
                max_speakers=max_speakers)
            if self._expects_num_speakers and num_speakers is None:
                if isinstance(file, Mapping) and "annotation" in file:
                    num_speakers = len(file["annotation"].labels())
                else:
                    raise ValueError(f"num_speakers must be provided when "
                                     f"using {self.klustering} clustering")
            waveform = source = sample_rate = None
            # the file's device unit starts with its first device call
            start = device_mark(self.device)
            # in training, a file whose caches hold what its models would
            # give is not even decoded
            if not (self.training and self.CACHED_SEGMENTATION in file and (
                    self._embedding is None
                    or self._cached_embeddings(file) is not None)):
                waveform, sample_rate = self._audio(file)
                source = self._source(waveform, file)

            with span("segmentation"):
                segmentations = self.get_segmentations(
                    file, hook=hook, source=source, sample_rate=sample_rate)
            hook("segmentation", segmentations)
            # queued behind segmentation, before anything the host waits for
            trunk = None
            if self._embedding is not None and not self.training:
                with span("embedding"):
                    trunk = self._start_shared_trunk(source)
            scores = segmentations.data                           # (C, F, S)
            binarized = segmentations
            if not self._powerset:
                threshold = self.segmentation.threshold
                binarized = SlidingWindowFeature(
                    hysteresis(scores.transpose(0, 1), threshold, threshold,
                               initial_on=False).transpose(0, 1).to(
                                   scores.dtype), segmentations.sliding_window)
            offsets, num_output_frames, window = self._aggregation_grid(
                segmentations.sliding_window,
                self._segmentation.model.receptive_field, scores.shape[0])
            offsets_dev = to_device(offsets, self.device)
            count, speaker_frames, clean_frames = fused_count_stats(
                binarized.data, offsets_dev, num_output_frames)
            fetch = {"count": count, "speaker_frames": speaker_frames,
                     "clean_frames": clean_frames}
            embeddings = None
            if self._embedding is not None:
                with span("embedding"):
                    embeddings = self.get_embeddings(
                        source, binarized,
                        exclude_overlap=self.embedding_exclude_overlap,
                        trunk=trunk, hook=hook, cache=file, defer_fetch=True)
                fetch["embeddings"] = embeddings
            host, event = self._fetch_async(fetch, timing=start is not None)
            device_unit("stage", file, start, event)
            return {"file": file, "hook": hook, "num_speakers": num_speakers,
                    "min_speakers": min_speakers, "max_speakers": max_speakers,
                    # the host waveform stays referenced until the file is
                    # finalized: a pinned one is what its upload reads
                    "waveform": waveform, "scores": scores,
                    "binarized": binarized.data,
                    "chunk_window": segmentations.sliding_window,
                    "offsets": offsets_dev,
                    "num_output_frames": num_output_frames, "window": window,
                    "host": host, "event": event}

    def apply(self, file: Dict, num_speakers: Optional[int] = None,
              min_speakers: Optional[int] = None,
              max_speakers: Optional[int] = None,
              hook: Optional[Callable] = None, **kwargs
              ) -> Union[DiarizeOutput, Annotation]:
        return self._finalize(self._stage(
            file, num_speakers=num_speakers, min_speakers=min_speakers,
            max_speakers=max_speakers, hook=hook, **kwargs))

    def apply_batch(self, files: List[Dict],
                    hook: Optional[Callable] = None, stage_ahead: int = 2,
                    **kwargs) -> List[DiarizeOutput]:
        """Pipelined apply over a list of files.

        Up to ``stage_ahead`` files are staged (their device programs
        queued) before the oldest one is finalized, so the host's
        clustering and annotation of a file overlap the device work of the
        next ones. Worker threads decode up to ``stage_ahead + 1`` files
        ahead of staging, host work only (read, downmix, page-locked
        copy); every CUDA call stays on this thread. A finalized file's
        device buffers, and the waveform this machinery decoded, are
        dropped. Span: ``decode_wait`` (a wait) where this thread joins a
        file's decode thread or decodes the file itself.
        """
        if not files:
            return []
        decode_threads: Dict[int, threading.Thread] = {}
        window = stage_ahead + 1

        def start_prefetch(j: int) -> None:
            if 0 < j < len(files) and j not in decode_threads:
                t = threading.Thread(target=self._decode_into,
                                     args=(files[j], False), daemon=True)
                t.start()
                decode_threads[j] = t

        for j in range(1, min(window + 1, len(files))):
            start_prefetch(j)
        staged: deque = deque()
        results = []
        try:
            # file 0 is on the critical path either way
            with span("decode_wait", files[0], wait=True):
                self._decode_into(files[0], False)
            for i, file in enumerate(files):
                t = decode_threads.pop(i, None)
                if t is not None or i > 0:
                    with span("decode_wait", file, wait=True):
                        if t is not None:
                            t.join()
                        else:
                            self._decode_into(file, False)
                start_prefetch(i + window)
                staged.append(self._stage(file, hook=hook, **kwargs))
                if len(staged) > stage_ahead:
                    results.append(self._finalize_and_release(
                        staged.popleft()))
            while staged:
                results.append(self._finalize_and_release(staged.popleft()))
        finally:
            for t in decode_threads.values():
                t.join()
        return results

    def _finalize_and_release(self, staged: Dict[str, Any]
                              ) -> Union[DiarizeOutput, Annotation]:
        """``_finalize``, then drop the file's device buffers and, for a
        dict this machinery decoded, its host waveform (the batch list
        keeps every dict alive)."""
        out = self._finalize(staged)
        _evict(staged["file"])
        return out

    def _reconstruct(self, staged: Dict[str, Any], hard_clusters: np.ndarray,
                     count: np.ndarray, num_clusters: int) -> np.ndarray:
        """(2, frames, clusters) float32: the normal and the exclusive
        discrete diarization, computed on the device (while recording on
        the card, the file's ``reconstruct`` device unit) and copied back
        in the ``reconstruct_wait`` span."""
        start = device_mark(self.device)
        binary, exclusive = fused_reconstruct(
            staged["scores"], to_device(hard_clusters, self.device),
            staged["offsets"], to_device(count, self.device),
            num_clusters, staged["num_output_frames"])
        both = torch.stack([binary, exclusive])
        device_unit("reconstruct", staged["file"], start,
                    device_mark(self.device))
        with span("reconstruct_wait", wait=True):
            both = both.cpu()
        return both.numpy().astype(np.float32)

    @torch.inference_mode()
    def _finalize(self, staged: Dict[str, Any]
                  ) -> Union[DiarizeOutput, Annotation]:
        """Host half of ``apply``: wait for the staged copies, cluster,
        reconstruct, annotate (spans ``finalize``, with ``staged_wait``,
        ``clustering``, ``reconstruct`` and ``annotate`` inside). Oracle
        clustering fetches the binarized scores here, never in
        ``_stage``."""
        file, hook = staged["file"], staged["hook"]
        with span("finalize", file):
            min_speakers = staged["min_speakers"]
            max_speakers = staged["max_speakers"]
            if staged["event"] is not None:
                with span("staged_wait", wait=True):
                    staged["event"].synchronize()
            host = {name: tensor.numpy()
                    for name, tensor in staged["host"].items()}
            count = SlidingWindowFeature(host["count"], staged["window"])
            hook("speaker_counting", count)

            if np.nanmax(count.data) == 0:
                # silent file
                output = DiarizeOutput(
                    Annotation(uri=file["uri"]), Annotation(uri=file["uri"]),
                    np.zeros((0, self._embedding.dimension
                              if self._embedding is not None else 0)))
                return output.speaker_diarization if self.legacy else output

            embeddings = host.get("embeddings")
            if embeddings is not None:
                hook("embeddings", embeddings)
            oracle = {}
            if isinstance(self.clustering, OracleClustering):
                oracle = {"segmentations": SlidingWindowFeature(
                              staged["binarized"].cpu().numpy(),
                              staged["chunk_window"]),
                          "file": file,
                          "frames": self._segmentation.model.receptive_field}
            with span("clustering"):
                hard_clusters, _, centroids = self.clustering(
                    embeddings, host["clean_frames"],
                    num_frames=staged["scores"].shape[1],
                    num_clusters=staged["num_speakers"],
                    min_clusters=min_speakers, max_clusters=max_speakers,
                    speaker_frames=host["speaker_frames"], **oracle)

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

            cnt = np.minimum(count.data, max_speakers).astype(
                np.int8).reshape(-1)
            hard_clusters = np.asarray(hard_clusters, dtype=np.int64)
            hard_clusters[host["speaker_frames"] == 0] = -2  # inactive
            num_clusters = max(int(hard_clusters.max()) + 1,
                               int(cnt.max()) if len(cnt) else 0, 1)
            with span("reconstruct"):
                binary, exclusive = self._reconstruct(
                    staged, hard_clusters, cnt, num_clusters)
            with span("annotate"):
                output = self._annotate(staged, file, hook, binary,
                                        exclusive, centroids)
            return output.speaker_diarization if self.legacy else output

    def _annotate(self, staged: Dict[str, Any], file, hook,
                  binary: np.ndarray, exclusive: np.ndarray,
                  centroids: Optional[np.ndarray]) -> DiarizeOutput:
        """Both diarizations as Annotations, labelled, and the centroids
        in their labels' order."""
        window = staged["window"]
        discrete = SlidingWindowFeature(binary, window)
        hook("discrete_diarization", discrete)

        min_duration_off = self.segmentation.min_duration_off
        diarization = self.to_annotation(discrete,
                                         min_duration_off=min_duration_off)
        exclusive_diarization = self.to_annotation(
            SlidingWindowFeature(exclusive, window),
            min_duration_off=min_duration_off)

        if file.get("annotation"):
            # the reference's labels, by the Hungarian mapping of overlap
            _, mapping = self.optimal_mapping(
                file["annotation"], diarization, return_mapping=True)
            mapping = {key: mapping.get(key, key)
                       for key in diarization.labels()}
        else:
            mapping = {label: expected for label, expected in
                       zip(diarization.labels(), self.classes())}
        diarization = diarization.rename_labels(mapping)
        exclusive_diarization = exclusive_diarization.rename_labels(mapping)
        diarization.uri = exclusive_diarization.uri = file["uri"]

        if centroids is not None:
            labels = diarization.labels()
            if len(labels) > centroids.shape[0]:
                centroids = np.pad(centroids, (
                    (0, len(labels) - centroids.shape[0]), (0, 0)))
            inverse_mapping = {label: index
                               for index, label in mapping.items()}
            centroids = centroids[[inverse_mapping[label]
                                   for label in labels]]
        return DiarizeOutput(diarization, exclusive_diarization, centroids)
