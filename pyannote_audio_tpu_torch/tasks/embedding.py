"""Speaker-embedding training: class-balanced batches and the ArcFace loss.

Counterpart of pyannote_audio_tpu/tasks/embedding.py. Batches hold
``num_classes_per_batch`` speakers x ``num_chunks_per_class`` chunks,
drawn from each speaker's turns of at least ``min_duration`` with the
same numpy generator calls, in the same order, as the JAX package's, so
that both give equal batches from the same protocol and seed. Each
batch's chunk duration is drawn in [min_duration, duration] and snapped
to a 0.25 s grid (kept from the JAX package, whose compiled step keys on
shape, so that the draws stay equal); a turn shorter than the duration is
cropped alone and zero-padded at a random offset. The loss is ArcFace's
additive angular margin softmax (margin 28.6 degrees, scale 64) against
class prototypes that the task owns: ``augment_params`` makes them,
``Trainer.fit`` trains them beside the model's parameters as
``task.trainable_params["arcface"]`` (``task.arcface``). Labels are class
indices and reach the loss as integers. Validation is by verification
trials (``pipelines.speaker_verification.main``), not a chunk grid.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.model import Problem, Resolution, Specifications
from ..core.segment import Segment
from ..core.task import Task, TrainingBatch, create_rng_for_worker
from ..utils.database import Protocol
from ..utils.runtime import exact_float32


def arcface_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, margin_deg: float = 28.6,
                 scale: float = 64.0) -> torch.Tensor:
    """Additive angular margin softmax (ArcFace, Deng et al. 2019):
    (batch, dim) embeddings, (batch,) integer labels and (classes, dim)
    prototypes -> the mean negative log-likelihood of the labels, the
    target class's angle widened by ``margin_deg``. Norms carry a 1e-8
    floor and cosines are clipped to +-(1 - 1e-7), as in the JAX
    package; the products are float32 with TF32 off."""
    margin = margin_deg * math.pi / 180.0
    with exact_float32():
        e = embeddings / (embeddings.norm(dim=-1, keepdim=True) + 1e-8)
        w = weights / (weights.norm(dim=-1, keepdim=True) + 1e-8)
        cos = torch.clamp(e @ w.t(), -1.0 + 1e-7, 1.0 - 1e-7)   # (B, C)
    labels = labels.long()
    # not F.one_hot, which reads the labels' maximum back to the host
    target = labels[:, None] == torch.arange(w.shape[0],
                                             device=labels.device)
    logits = scale * torch.where(target, torch.cos(torch.acos(cos) + margin),
                                 cos)
    log_probs = F.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels[:, None]).mean()


class SupervisedRepresentationLearningWithArcFace(Task):
    """ArcFace speaker-embedding task."""

    def __init__(self, protocol: Protocol, min_duration: float = 2.0,
                 duration: float = 5.0, num_classes_per_batch: int = 8,
                 num_chunks_per_class: int = 4, margin: float = 28.6,
                 scale: float = 64.0, **kwargs):
        kwargs.setdefault("batch_size",
                          num_classes_per_batch * num_chunks_per_class)
        super().__init__(protocol, duration=duration,
                         min_duration=min_duration, **kwargs)
        self.num_classes_per_batch = num_classes_per_batch
        self.num_chunks_per_class = num_chunks_per_class
        self.margin = margin
        self.scale = scale
        self._speech_turns: Dict[str, List[Tuple[Dict, Segment]]] = {}
        self.trainable_params: Dict[str, torch.nn.Parameter] = {}

    def setup(self, model=None) -> None:
        super().setup(model)
        # each speaker's turns of at least min_duration
        self._speech_turns = {}
        for file in self._train_files:
            for seg, _, label in file["annotation"].itertracks(
                    yield_label=True):
                if seg.duration < self.min_duration:
                    continue
                self._speech_turns.setdefault(str(label), []).append(
                    (file, seg))
        self.classes = sorted(self._speech_turns)
        self.specifications = Specifications(
            problem=Problem.REPRESENTATION, resolution=Resolution.CHUNK,
            duration=self.duration, min_duration=self.min_duration,
            classes=self.classes)

    def augment_params(self, model, generator=None) -> Dict[str, torch.Tensor]:
        """The (classes, dimension) prototypes, N(0, 0.01^2)."""
        return {"arcface": torch.randn(
            (len(self.classes), model.dimension), generator=generator)
            * 0.01}

    @property
    def arcface(self) -> torch.nn.Parameter:
        """The class prototypes being trained (set by ``Trainer.fit``)."""
        return self.trainable_params["arcface"]

    def train_batches(self, epoch: int = 0, worker_id: int = 0,
                      rank: int = 0) -> Iterator[TrainingBatch]:
        rng = create_rng_for_worker(self.seed, epoch=epoch,
                                    worker_id=worker_id, rank=rank)
        classes = self.classes
        num_batches = max(1, self.train__len__() // self.batch_size)
        for _ in range(num_batches):
            duration = rng.uniform(self.min_duration, self.duration)
            duration = min(self.duration, max(
                self.min_duration, round(duration / 0.25) * 0.25))
            num_samples = int(round(duration * self.audio.sample_rate))
            chosen = rng.choice(len(classes),
                                size=min(self.num_classes_per_batch,
                                         len(classes)), replace=False)
            X, y = [], []
            for ci in chosen:
                turns = self._speech_turns[classes[ci]]
                # a turn in proportion to its duration, drawn per chunk
                durations = np.array([seg.duration for _, seg in turns])
                p = durations / durations.sum()
                for _ in range(self.num_chunks_per_class):
                    file, seg = turns[rng.choice(len(turns), p=p)]
                    if seg.duration < duration:
                        # the turn alone, zero-padded at a random offset:
                        # a longer crop would label a neighbour's speech
                        waveform, _ = self.audio.crop(file, seg)
                        missing = num_samples - waveform.shape[1]
                        if missing > 0:
                            left = int(rng.integers(0, missing + 1))
                            waveform = np.pad(
                                waveform, ((0, 0), (left, missing - left)))
                    else:
                        start = seg.start + rng.uniform() * \
                            (seg.duration - duration)
                        waveform, _ = self.audio.crop(
                            file, Segment(start, start + duration),
                            duration=duration, mode="pad")
                    X.append(waveform[:, :num_samples])
                    y.append(ci)
            yield TrainingBatch(X=np.stack(X),
                                y=np.asarray(y, dtype=np.int32))

    def train__len__(self) -> int:
        total = sum(seg.duration for turns in self._speech_turns.values()
                    for _, seg in turns)
        return max(self.batch_size, math.floor(total / self.duration))

    def prepare_validation(self):
        """Nothing for the trainer's chunk-grid validation: embeddings are
        validated on verification trials."""
        return []

    def default_metric(self) -> List:
        """[EqualErrorRate, BinnedAUROC] over verification-trial scores."""
        from ..metrics.auroc import BinnedAUROC
        from ..metrics.streaming import EqualErrorRate
        return [EqualErrorRate(), BinnedAUROC()]

    def loss(self, model, batch: TrainingBatch) -> torch.Tensor:
        return self.loss_from_output(model(batch.X), batch)

    def loss_from_output(self, output, batch: TrainingBatch) -> torch.Tensor:
        return arcface_loss(output, batch.y, self.trainable_params["arcface"],
                            margin_deg=self.margin, scale=self.scale)


#: the reference's name for the class-balanced sampling mixin, which here
#: is one class with the ArcFace task
SupervisedRepresentationLearningTaskMixin = \
    SupervisedRepresentationLearningWithArcFace
