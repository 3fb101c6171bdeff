"""Frame-level segmentation tasks: VAD, multi-label and speaker diarization.

Counterpart of pyannote_audio_tpu/tasks/segmentation.py: the shared chunk
preparation (frame targets at the model's resolution, per-frame weights,
warm-up masking) and the three tasks. Chunks are prepared on the host in
numpy, as in the JAX package, so both give the same batches; each task's
``loss(model, batch)`` runs the port's ``nn.Module`` on device tensors.
The permutation-invariant diarization loss is the powerset NLL minimised
over the K! speaker permutations (``ops.losses.powerset_pit_loss``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Text

import numpy as np
import torch

from ..core.model import Problem, Resolution, Specifications
from ..core.segment import Segment, SlidingWindowFeature
from ..core.task import Task
from ..ops.losses import (binary_cross_entropy, interpolate_weight,
                          powerset_pit_loss)
from ..ops.powerset import Powerset
from ..utils.database import Protocol


class SegmentationTaskMixin(Task):
    """Shared chunk preparation for frame-level tasks."""

    #: name of the file key carrying per-frame loss weights; None means
    #: unweighted
    weight: Optional[Text] = None

    def default_metric(self):
        """Macro-average AUROC over classes (binned, streaming)."""
        from ..metrics.auroc import BinnedAUROC
        problem = self.specifications.problem
        if problem in (Problem.BINARY_CLASSIFICATION,
                       Problem.MULTI_LABEL_CLASSIFICATION,
                       Problem.MONO_LABEL_CLASSIFICATION):
            return BinnedAUROC()
        raise RuntimeError(
            f"The {problem} problem type hasn't been given a default "
            f"segmentation metric yet.")

    def chunk_weight(self, file: Dict, chunk: Segment
                     ) -> Optional[np.ndarray]:
        """(frames, 1) per-frame loss weight cropped from file[self.weight].

        The key holds a SlidingWindowFeature (cropped to the chunk, a
        fixed number of frames) or a plain array covering the whole file
        at the task's frame rate, of which the chunk's share is sliced by
        time ratio at a fixed length (padded at the file's tail), so that
        every chunk of a batch has as many frames. The fixed crop takes
        the task's duration, not the chunk's ``end - start``: the JAX
        package takes the latter, whose rounding can cost a frame and
        make a batch's weights unstackable; elsewhere the two agree.
        """
        if self.weight is None:
            return None
        values = file.get(self.weight)
        if values is None:
            return None
        if isinstance(values, SlidingWindowFeature):
            data = values.crop_fixed(chunk, fixed=self.duration)
        else:
            data = np.asarray(values, dtype=np.float32)
            total = file.get("duration")
            if total is None and "annotated" in file:
                total = file["annotated"].extent().end
            if total:
                n = data.shape[0]
                length = max(1, int(round(
                    self.duration / float(total) * n)))
                i0 = min(max(int(round(chunk.start / float(total) * n)),
                             0), max(n - 1, 0))
                data = data[i0:i0 + length]
                if data.shape[0] < length:
                    data = np.pad(data, [(0, length - data.shape[0])]
                                  + [(0, 0)] * (data.ndim - 1))
        data = np.nan_to_num(np.asarray(data, dtype=np.float32), nan=0.0)
        if data.ndim == 1:
            data = data[:, None]
        return data[:, :1]

    def loss_weight(self, batch, num_frames: int
                    ) -> Optional[torch.Tensor]:
        """(B, num_frames, 1) loss weight on the batch's device, or None
        when unweighted: the per-frame ``weight`` linearly interpolated to
        the prediction's frames, with the warm-up frames at either end
        zeroed."""
        left = round(self.warm_up[0] / self.duration * num_frames)
        right = round(self.warm_up[1] / self.duration * num_frames)
        w = batch.weight
        if w is None and left == 0 and right == 0:
            return None
        if w is None:
            w = torch.ones((batch.X.shape[0], num_frames, 1),
                           device=batch.X.device)
        else:
            w = interpolate_weight(torch.as_tensor(
                w, dtype=torch.float32, device=batch.X.device), num_frames)
        if left > 0 or right > 0:
            w = w.clone()
            w[:, :left] = 0.0
            if right > 0:
                w[:, num_frames - right:] = 0.0
        return w

    def frame_targets(self, file: Dict, chunk: Segment,
                      labels: Sequence[Text]) -> np.ndarray:
        """file['annotation'] over the chunk at the model's frames."""
        if self.model is not None:
            num_samples = int(round(self.duration
                                    * self.audio.sample_rate))
            num_frames = self.model.num_frames(num_samples)
        else:
            num_frames = int(round(self.duration * 100))
        step = self.duration / num_frames
        data = np.zeros((num_frames, len(labels)), dtype=np.float32)
        cropped = file["annotation"].crop(chunk)
        for seg, _, label in cropped.itertracks(yield_label=True):
            if label not in labels:
                continue
            k = labels.index(label)
            i0 = int(round((seg.start - chunk.start) / step))
            i1 = int(round((seg.end - chunk.start) / step))
            data[max(i0, 0):min(i1, num_frames), k] = 1.0
        return data

    def crop_waveform(self, file: Dict, chunk: Segment) -> np.ndarray:
        waveform, _ = self.audio.crop(file, chunk, duration=self.duration,
                                      mode="pad")
        return waveform

    def _with_weight(self, out: Dict, file: Dict, chunk: Segment) -> Dict:
        w = self.chunk_weight(file, chunk)
        if w is not None:
            out["weight"] = w
        return out

    def loss_from_output(self, output, batch):
        """Frame-weighted BCE on probabilities (VAD, multi-label)."""
        return binary_cross_entropy(output, batch.y, weight=self.loss_weight(
            batch, output.shape[1]))


class VoiceActivityDetection(SegmentationTaskMixin):
    """Binary speech / non-speech."""

    def __init__(self, protocol: Protocol, duration: float = 2.0,
                 balance=None, weight: Optional[Text] = None, **kwargs):
        super().__init__(protocol, duration=duration, balance=balance,
                         **kwargs)
        self.weight = weight

    def setup(self, model=None) -> None:
        super().setup(model)
        self.specifications = Specifications(
            problem=Problem.BINARY_CLASSIFICATION,
            resolution=Resolution.FRAME, duration=self.duration,
            warm_up=self.warm_up, classes=["speech"])

    def prepare_chunk(self, file: Dict, chunk: Segment, rng) -> Dict:
        X = self.crop_waveform(file, chunk)
        targets = self.frame_targets(file, chunk,
                                     file["annotation"].labels())
        if targets.shape[1] == 0:
            # speech-free file: a legitimate all-negative example
            speech = np.zeros((targets.shape[0], 1), targets.dtype)
        else:
            speech = targets.max(axis=1, keepdims=True)
        return self._with_weight({"X": X, "y": speech}, file, chunk)


class MultiLabelSegmentation(SegmentationTaskMixin):
    """K-class frame classification; the classes default to every label
    of the training files, sorted."""

    def __init__(self, protocol: Protocol,
                 classes: Optional[List[Text]] = None,
                 duration: float = 2.0, weight: Optional[Text] = None,
                 **kwargs):
        super().__init__(protocol, duration=duration, **kwargs)
        self.classes = classes
        self.weight = weight

    def setup(self, model=None) -> None:
        super().setup(model)
        if self.classes is None:
            labels = set()
            for file in self._train_files:
                labels.update(file["annotation"].labels())
            self.classes = sorted(labels)
        self.specifications = Specifications(
            problem=Problem.MULTI_LABEL_CLASSIFICATION,
            resolution=Resolution.FRAME, duration=self.duration,
            warm_up=self.warm_up, classes=self.classes)

    def prepare_chunk(self, file: Dict, chunk: Segment, rng) -> Dict:
        return self._with_weight(
            {"X": self.crop_waveform(file, chunk),
             "y": self.frame_targets(file, chunk, self.classes)},
            file, chunk)


class SpeakerDiarization(SegmentationTaskMixin):
    """Permutation-invariant powerset diarization.

    ``max_speakers_per_chunk`` defaults to the 97th percentile of the
    speaker count over windows of the training files; targets keep a
    chunk's most talkative speakers; the loss is the PIT powerset NLL,
    each frame optionally weighed by its target class's cardinality.
    """

    def __init__(self, protocol: Protocol, duration: float = 10.0,
                 max_speakers_per_chunk: Optional[int] = None,
                 max_speakers_per_frame: Optional[int] = 2,
                 weigh_by_cardinality: bool = False,
                 weight: Optional[Text] = None, **kwargs):
        super().__init__(protocol, duration=duration, **kwargs)
        self.weight = weight
        self.max_speakers_per_chunk = max_speakers_per_chunk
        self.max_speakers_per_frame = max_speakers_per_frame
        self.weigh_by_cardinality = weigh_by_cardinality
        self._powerset: Optional[Powerset] = None

    def estimate_max_speakers_per_chunk(self) -> int:
        """97th percentile of the speaker count over windows of the
        chunk duration, a quarter of it apart, at least 2."""
        counts = []
        for file in self._train_files:
            annotation = file["annotation"]
            extent = annotation.get_timeline().extent()
            if not extent:
                continue
            step = self.duration / 4
            t = extent.start
            while t + self.duration <= extent.end + step:
                window = Segment(t, t + self.duration)
                counts.append(len(annotation.crop(window).labels()))
                t += step
        if not counts:
            return 2
        return max(2, int(np.ceil(np.percentile(counts, 97))))

    def setup(self, model=None) -> None:
        super().setup(model)
        if self.max_speakers_per_chunk is None:
            self.max_speakers_per_chunk = \
                self.estimate_max_speakers_per_chunk()
        self.specifications = Specifications(
            problem=Problem.MONO_LABEL_CLASSIFICATION,
            resolution=Resolution.FRAME, duration=self.duration,
            warm_up=self.warm_up,
            classes=[f"speaker#{i + 1}"
                     for i in range(self.max_speakers_per_chunk)],
            powerset_max_classes=self.max_speakers_per_frame,
            permutation_invariant=True)
        self._powerset = Powerset(self.max_speakers_per_chunk,
                                  self.max_speakers_per_frame)

    @property
    def powerset(self) -> Powerset:
        if self._powerset is None:
            raise RuntimeError("call task.setup() first")
        return self._powerset

    def default_metric(self) -> Dict:
        """DER and its components at threshold 0.5."""
        from ..metrics.streaming import (DetectionErrorRate,
                                         DiarizationErrorRate,
                                         DiarizationPrecision,
                                         DiarizationRecall,
                                         FalseAlarmRate,
                                         MissedDetectionRate,
                                         SpeakerConfusionRate)
        return {
            "DiarizationErrorRate": DiarizationErrorRate(0.5),
            "DiarizationErrorRate/Confusion": SpeakerConfusionRate(0.5),
            "DiarizationErrorRate/Miss": MissedDetectionRate(0.5),
            "DiarizationErrorRate/FalseAlarm": FalseAlarmRate(0.5),
            "DiarizationErrorRate/Precision": DiarizationPrecision(0.5),
            "DiarizationErrorRate/Recall": DiarizationRecall(0.5),
            "DiarizationErrorRate/DetectionErrorRate":
                DetectionErrorRate(0.5),
        }

    def prepare_chunk(self, file: Dict, chunk: Segment, rng
                      ) -> Optional[Dict]:
        X = self.crop_waveform(file, chunk)
        labels = file["annotation"].crop(chunk).labels()
        y = self.frame_targets(file, chunk, labels)   # (F, num_local)
        K = self.max_speakers_per_chunk
        if y.shape[1] > K:
            # keep the K most talkative speakers
            talkative = np.argsort(-y.sum(axis=0))[:K]
            y = y[:, talkative]
        if y.shape[1] < K:
            y = np.pad(y, ((0, 0), (0, K - y.shape[1])))
        return self._with_weight({"X": X, "y": y}, file, chunk)

    def loss_from_output(self, output, batch):
        class_weight = torch.clamp(self.powerset.cardinality, min=1) \
            if self.weigh_by_cardinality else None
        loss, _ = powerset_pit_loss(
            output, batch.y, self.powerset,
            weight=self.loss_weight(batch, output.shape[1]),
            class_weight=class_weight)
        return loss


def discretize(annotation, support: Segment, window) -> np.ndarray:
    """(frames, labels) 0/1 array of ``annotation`` over ``support`` at
    the frames of ``window`` (a SlidingWindow; its step sets the frame
    rate, the frames start at the support's start)."""
    labels = annotation.labels()
    num_frames = int(np.rint(support.duration / window.step))
    data = np.zeros((num_frames, len(labels)), dtype=np.float32)
    for seg, _, label in annotation.itertracks(yield_label=True):
        inter = seg & support
        if not inter:
            continue
        i0 = int(np.rint((inter.start - support.start) / window.step))
        i1 = int(np.rint((inter.end - support.start) / window.step))
        data[max(i0, 0):min(i1, num_frames), labels.index(label)] = 1.0
    return data


def evaluate(protocol, subset: str = "test", model=None,
             registry: Optional[str] = None, onset: float = 0.5,
             display: bool = True, device=None) -> float:
    """Frame-level DER of a segmentation model over a protocol's subset:
    sliding inference, hysteresis binarization at ``onset``, the
    reference discretized at the output frames, DER accumulated over the
    files (one per file printed with ``display``). ``model`` is a module
    or a checkpoint path, ``protocol`` a protocol or a registered name
    (``registry``: a database.yml to register first); ``device`` as for
    ``Inference``."""
    from ..core.inference import Inference
    from ..core.model import Model
    from ..metrics.streaming import DiarizationErrorRate
    from ..utils.database import get_protocol, register_database
    from ..utils.signal import binarize_swf

    if registry:
        register_database(registry)
    if isinstance(protocol, str):
        protocol = get_protocol(protocol)
    if not isinstance(model, torch.nn.Module):
        model = Model.from_pretrained(model)
    inference = Inference(model, device=device)
    metric = DiarizationErrorRate()
    rows = []
    for file in getattr(protocol, subset)():
        hyp = binarize_swf(inference(file), onset=onset)
        window = hyp.sliding_window
        support = Segment(0.0, window[len(hyp.data) - 1].middle
                          + 0.5 * window.step)
        ref = discretize(file["annotation"], support, window)
        n = min(len(ref), len(hyp.data))
        der = metric(np.asarray(hyp.data[:n])[None], ref[:n][None])
        rows.append((file.get("uri", "?"), der))
    aggregate = metric.compute()
    if display:
        for uri, der in rows:
            print(f"{uri}: DER={100 * der:.2f}%")
        print(f"TOTAL DER = {100 * aggregate:.2f}%")
    return aggregate


#: the reference's name for the shared segmentation-task base
SegmentationTask = SegmentationTaskMixin
