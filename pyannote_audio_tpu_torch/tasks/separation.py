"""PixIT: joint speaker diarization and MixIT speech separation.

Counterpart of pyannote_audio_tpu/tasks/separation.py: dual
``Specifications`` (per-source diarization, then regression of the
sources); training chunks drawn as the base task draws them, each paired
with a mixture of mixtures (MoM) built from two single-speaker regions of
one training file, with the same numpy generator calls in the same order
as the JAX package's, so that both give equal batches; the loss
``(1 - w) * PIT BCE + w * MixIT``. The PIT diarization loss aligns the
predicted sources to the target speakers over the K! permutations on the
device (``ops.permutation.permutate_device``); MixIT scores every
assignment of the estimated sources to the two mixtures as one static
(P, n_src) matrix (an einsum and a min, no host solver). An item without
a drawable MoM carries weight 0 in MixIT. Without drawn MoMs (validation)
the batch's items are paired even with odd; a single item has no MoM.

``pixit_optimizer`` is the Trainer's optimizer factory for PixIT: one
Adam over two parameter groups, WavLM's (``wavlm.*``) at ``wavlm_lr`` and
the rest at ``lr``, under one global-norm clip over both.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.model import Problem, Resolution, Specifications
from ..core.segment import Segment
from ..core.task import Task, TrainingBatch, create_rng_for_worker
from ..ops.losses import binary_cross_entropy
from ..ops.permutation import permutate_device
from ..utils.database import Protocol
from ..utils.runtime import exact_float32


def negative_sisdr(estimate: torch.Tensor, target: torch.Tensor
                   ) -> torch.Tensor:
    """-SI-SDR in dB over the last axis (both zero-meaned; 1e-8 floors)."""
    target = target - target.mean(dim=-1, keepdim=True)
    estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    dot = (estimate * target).sum(dim=-1, keepdim=True)
    energy = target.square().sum(dim=-1, keepdim=True) + 1e-8
    projection = dot / energy * target
    noise = estimate - projection
    ratio = projection.square().sum(dim=-1) / (noise.square().sum(dim=-1)
                                               + 1e-8)
    return -10.0 * torch.log10(ratio + 1e-8)


def mixit_partitions(n_src: int) -> np.ndarray:
    """(P, n_src) binary matrices assigning sources to mixture 1 (each
    mixture gets at least one)."""
    rows = [np.array(bits, dtype=np.float32)
            for bits in itertools.product([0.0, 1.0], repeat=n_src)
            if 0 < sum(bits) < n_src]
    return np.stack(rows)


def mixit_loss(est_sources: torch.Tensor, mix1: torch.Tensor,
               mix2: torch.Tensor, weight: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(B, T, n_src) estimated sources against their two mixtures (B, T)
    each: per item, the least over the assignments of the mean of the two
    mixtures' negative SI-SDR; the batch mean, or the ``weight``-weighted
    mean (sum(w * loss) / max(sum(w), 1))."""
    parts = torch.as_tensor(mixit_partitions(est_sources.shape[-1]),
                            dtype=est_sources.dtype,
                            device=est_sources.device)            # (P, S)
    with exact_float32():
        est1 = torch.einsum("bts,ps->bpt", est_sources, parts)
        est2 = torch.einsum("bts,ps->bpt", est_sources, 1.0 - parts)
    loss = 0.5 * (negative_sisdr(est1, mix1[:, None, :])
                  + negative_sisdr(est2, mix2[:, None, :]))      # (B, P)
    per_item = loss.min(dim=-1).values                            # (B,)
    if weight is None:
        return per_item.mean()
    return (per_item * weight).sum() / torch.clamp(weight.sum(), min=1.0)


def pixit_optimizer(lr: float = 1e-3, wavlm_lr: float = 1e-5,
                    gradient_clip_val: float = 5.0):
    """``Trainer(optimizer=pixit_optimizer(...))``: a factory of one Adam
    over two groups, every parameter with a ``wavlm`` name component at
    ``wavlm_lr`` and the others at ``lr``; ``Trainer.train_step`` clips
    the gradients of both groups together by their global norm to
    ``gradient_clip_val`` first. Capturable on a CUDA device, as the
    trainer's own Adam."""
    def factory(named_params: Sequence[Tuple[str, torch.nn.Parameter]]
                ) -> torch.optim.Optimizer:
        wavlm = [p for n, p in named_params if "wavlm" in n.split(".")]
        rest = [p for n, p in named_params if "wavlm" not in n.split(".")]
        groups = [{"params": ps, "lr": group_lr}
                  for ps, group_lr in ((wavlm, wavlm_lr), (rest, lr)) if ps]
        optimizer = torch.optim.Adam(
            groups, lr=lr,
            capturable=named_params[0][1].device.type == "cuda")
        optimizer.gradient_clip_val = gradient_clip_val
        return optimizer
    return factory


class ValDataset:
    """Iterable over PixIT's fixed validation grid, each chunk prepared as
    a training chunk is."""

    def __init__(self, task: "PixIT"):
        self.task = task
        self._grid = task.prepare_validation()

    def __iter__(self):
        rng = np.random.default_rng(self.task.seed)
        for file, chunk in self._grid:
            yield self.task.prepare_chunk(file, chunk, rng)

    def __len__(self) -> int:
        return len(self._grid)


class PixIT(Task):
    """Joint diarization + separation training."""

    #: Trainer.validate sweeps the Optimal* DER family over the sigmoid
    #: outputs of the diarization branch
    val_optimal_der = True

    def __init__(self, protocol: Protocol, duration: float = 5.0,
                 max_speakers_per_chunk: int = 3,
                 separation_loss_weight: float = 0.5, **kwargs):
        super().__init__(protocol, duration=duration, **kwargs)
        self.max_speakers_per_chunk = max_speakers_per_chunk
        self.separation_loss_weight = separation_loss_weight

    @property
    def val_monitor(self):
        return "der/val/optimal", "min"

    def default_metric(self) -> Dict:
        """The Optimal (threshold-swept) DER family."""
        from ..metrics.streaming import (OptimalDiarizationErrorRate,
                                         OptimalDiarizationErrorRateThreshold,
                                         OptimalFalseAlarmRate,
                                         OptimalMissedDetectionRate,
                                         OptimalSpeakerConfusionRate)
        return {
            "DiarizationErrorRate": OptimalDiarizationErrorRate(),
            "DiarizationErrorRate/Threshold":
                OptimalDiarizationErrorRateThreshold(),
            "DiarizationErrorRate/Confusion": OptimalSpeakerConfusionRate(),
            "DiarizationErrorRate/Miss": OptimalMissedDetectionRate(),
            "DiarizationErrorRate/FalseAlarm": OptimalFalseAlarmRate(),
        }

    def setup(self, model=None) -> None:
        super().setup(model)
        classes = [f"speaker#{i + 1}"
                   for i in range(self.max_speakers_per_chunk)]
        self.specifications = (
            Specifications(problem=Problem.MULTI_LABEL_CLASSIFICATION,
                           resolution=Resolution.FRAME,
                           duration=self.duration, classes=classes,
                           permutation_invariant=True),
            Specifications(problem=Problem.REGRESSION,
                           resolution=Resolution.FRAME,
                           duration=self.duration, classes=classes,
                           permutation_invariant=True))

    # -- mixtures of mixtures ------------------------------------------------

    def _single_speaker_regions(self, file) -> List[Tuple[Segment, str]]:
        """(region, label) of every stretch of at least the chunk duration
        where one speaker alone is active; computed once per file and kept
        in the file dict."""
        cached = file.get("_single_speaker_regions")
        if cached is not None:
            return cached
        annotation = file["annotation"]
        out = []
        for label in annotation.labels():
            own = annotation.label_timeline(label).support()
            others = annotation.subset([label], invert=True) \
                .get_timeline().support()
            for seg in own:
                for clean in others.gaps(support=seg).crop(seg):
                    if clean.duration >= self.duration:
                        out.append((clean, label))
        try:
            file["_single_speaker_regions"] = out
        except TypeError:
            pass                       # an immutable mapping: no cache
        return out

    def draw_mom(self, rng: np.random.Generator
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Two single-speaker chunks of one file (of two speakers where
        the file has two) -> (mix1, mix2), or None without such a file."""
        candidates = [f for f in self._train_files
                      if len(self._single_speaker_regions(f)) >= 2]
        if not candidates:
            return None
        file = candidates[rng.integers(len(candidates))]
        regions = self._single_speaker_regions(file)
        (r1, l1), (r2, l2) = (regions[i] for i in
                              rng.choice(len(regions), 2, replace=False))
        if l1 == l2 and len({l for _, l in regions}) > 1:
            others = [(r, l) for r, l in regions if l != l1]
            r2, l2 = others[rng.integers(len(others))]

        def crop(region):
            start = region.start + rng.uniform() * \
                max(region.duration - self.duration, 0.0)
            waveform, _ = self.audio.crop(
                file, Segment(start, start + self.duration),
                duration=self.duration, mode="pad")
            return waveform[0]
        return crop(r1), crop(r2)

    def train_batches(self, epoch: int = 0, worker_id: int = 0,
                      rank: int = 0) -> Iterator[TrainingBatch]:
        rng = create_rng_for_worker(self.seed, epoch=epoch,
                                    worker_id=worker_id, rank=rank)
        num_batches = max(1, self.train__len__() // self.batch_size)
        num_samples = int(round(self.duration * self.audio.sample_rate))
        for _ in range(num_batches):
            X, y, mix1, mix2, mom_weight = [], [], [], [], []
            while len(X) < self.batch_size:
                file, chunk = self.draw_chunk(rng)
                labels = file["annotation"].crop(chunk).labels()
                if len(labels) > self.max_speakers_per_chunk:
                    continue
                waveform, _ = self.audio.crop(file, chunk,
                                              duration=self.duration,
                                              mode="pad")
                X.append(waveform)
                y.append(self._frame_targets(file, chunk, labels))
                mom = self.draw_mom(rng)
                if mom is None:
                    # static shapes: a dummy pair, its weight 0 in MixIT
                    mom = (waveform[0], np.zeros_like(waveform[0]))
                    mom_weight.append(0.0)
                else:
                    mom_weight.append(1.0)
                mix1.append(mom[0][:num_samples])
                mix2.append(mom[1][:num_samples])
            yield TrainingBatch(
                X=np.stack(X), y=np.stack(y),
                meta={"mix1": np.stack(mix1), "mix2": np.stack(mix2),
                      "mom_weight": np.asarray(mom_weight, np.float32)})

    def _frame_targets(self, file, chunk, labels) -> np.ndarray:
        """(frames, max_speakers_per_chunk) activity of ``labels`` (in
        that order) over ``chunk`` at the model's frames."""
        if self.model is not None:
            num_samples = int(round(self.duration * self.audio.sample_rate))
            num_frames = self.model.num_frames(num_samples)
        else:
            num_frames = int(round(self.duration * 125))
        step = self.duration / num_frames
        K = self.max_speakers_per_chunk
        data = np.zeros((num_frames, K), dtype=np.float32)
        for seg, _, label in file["annotation"].crop(chunk).itertracks(
                yield_label=True):
            if label not in labels:
                continue
            k = labels.index(label)
            if k >= K:
                continue
            i0 = int(round((seg.start - chunk.start) / step))
            i1 = int(round((seg.end - chunk.start) / step))
            data[max(i0, 0):min(i1, num_frames), k] = 1.0
        return data

    # -- validation ------------------------------------------------------------

    def prepare_chunk(self, file: Dict, chunk: Segment,
                      rng: np.random.Generator) -> Dict:
        """A validation chunk: waveform and frame targets of its most
        talkative speakers (no drawn MoM: the loss pairs the batch's
        items)."""
        cropped = file["annotation"].crop(chunk)
        labels = cropped.labels()
        if len(labels) > self.max_speakers_per_chunk:
            labels = sorted(labels, key=lambda l: cropped.label_duration(l),
                            reverse=True)[:self.max_speakers_per_chunk]
        waveform, _ = self.audio.crop(file, chunk, duration=self.duration,
                                      mode="pad")
        return {"X": waveform,
                "y": self._frame_targets(file, chunk, labels)}

    # -- loss ------------------------------------------------------------------

    def loss(self, model, batch: TrainingBatch) -> torch.Tensor:
        diarization, _ = model(batch.X)
        return self._joint_loss(model, diarization, batch)

    def validation_loss(self, model, output, batch: TrainingBatch
                        ) -> torch.Tensor:
        """The loss from the validation forward's diarization ``output``,
        with the within-batch MoM's forward."""
        return self._joint_loss(model, output, batch)

    def _joint_loss(self, model, diarization: torch.Tensor,
                    batch: TrainingBatch) -> torch.Tensor:
        """(1 - w) * PIT BCE of ``diarization`` + w * MixIT on the drawn
        MoMs (``batch.meta``), else on the batch's even + odd items."""
        X, y = batch.X, batch.y
        n = min(diarization.shape[1], y.shape[1])
        permuted, _ = permutate_device(y[:, :n], diarization[:, :n])
        diar_loss = binary_cross_entropy(permuted, y[:, :n])
        meta = batch.meta or {}
        mom_weight = None
        if "mix1" in meta:
            mix1, mix2 = meta["mix1"], meta["mix2"]
            mom_weight = meta.get("mom_weight")
        elif X.shape[0] >= 2:
            even = X.shape[0] - X.shape[0] % 2
            mix1 = X[0:even:2, 0]
            mix2 = X[1:even:2, 0]
        else:
            # one item: no MoM; the (1 - w) weighting keeps the scale
            return (1.0 - self.separation_loss_weight) * diar_loss
        _, est_sources = model((mix1 + mix2)[:, None, :])
        sep_loss = mixit_loss(est_sources, mix1, mix2, weight=mom_weight)
        w = self.separation_loss_weight
        return (1.0 - w) * diar_loss + w * sep_loss
