"""The plain reference of a whole diarization configuration.

``ReferencePipeline(config, weights, device)`` runs, stage by stage, what
the configuration's pipeline computes for one recording: the chunk grid
(chunks of ``duration`` every ``step``, the last one zero-padded), the
segmentation model over the chunks, hard powerset decoding, the speaker
count, the embedding masks, the embeddings, the clustering and the
reconstruction into segments. ``config`` is the configuration's JSON
(``portbench/configs/<name>.json``); ``weights`` the state dicts and
PLDA arrays that the benchmark drew and handed the program too.

Imports neither the program, nor JAX, nor the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import clustering, pyannet, reconstruct, resnet
from .numerics import Numerics


class ReferencePipeline:
    def __init__(self, config: dict, weights: Dict[str, dict], device):
        self.config, self.weights, self.device = config, weights, device
        seg = config["segmentation"]
        self.sample_rate = seg["hparams"]["sample_rate"]
        self.duration = seg["specifications"]["duration"]
        self.window = int(round(self.duration * self.sample_rate))
        self.step = int(round(config["segmentation_step"] * self.window))
        self.mapping = pyannet.powerset_mapping(
            len(seg["specifications"]["classes"]),
            seg["specifications"]["powerset_max_classes"])
        self.frame_duration, self.frame_step = self.segmentation_frames()
        self.clusterer = clustering.method(
            config["clustering"]["kind"], config["instantiate"]["clustering"],
            weights)

    # -- segmentation -------------------------------------------------------

    def segmentation_frames(self):
        from . import segmentation_models
        return segmentation_models.frames(self.config["segmentation"])

    def starts(self, num_samples: int) -> np.ndarray:
        w, s = self.window, self.step
        full = 1 + (num_samples - w) // s if num_samples >= w else 0
        last = num_samples < w or (num_samples - w) % s > 0
        return np.arange(full + int(last), dtype=np.int64) * s

    def padded(self, samples: np.ndarray) -> torch.Tensor:
        starts = self.starts(len(samples))
        total = int(starts[-1]) + self.window
        x = torch.zeros(total, device=self.device)
        x[:len(samples)] = torch.as_tensor(samples, device=self.device)
        return x

    def logprobs(self, samples: np.ndarray, num: Numerics) -> torch.Tensor:
        """(C, frames, powerset classes) for the recording."""
        from . import segmentation_models
        x = self.padded(samples)
        starts = self.starts(len(samples))
        chunks = x.unfold(0, self.window, self.step)[:len(starts), None]
        with torch.inference_mode():
            return segmentation_models.forward(
                self.config["segmentation"], self.weights["segmentation"],
                chunks, num)

    def ssl_output(self, samples: np.ndarray, chunks: int, num: Numerics
                   ) -> Optional[torch.Tensor]:
        """The SSL trunk's last layer over the recording's first
        ``chunks`` chunks, or None where the model has no SSL trunk."""
        from . import segmentation_models
        x = self.padded(samples).unfold(0, self.window, self.step)[:chunks]
        with torch.inference_mode():
            return segmentation_models.ssl_output(
                self.config["segmentation"], self.weights["segmentation"], x,
                num)

    def binarize(self, logprobs: torch.Tensor) -> torch.Tensor:
        return pyannet.to_multilabel(logprobs, self.mapping)

    # -- embeddings -----------------------------------------------------------

    def min_num_frames(self, num_frames: int) -> int:
        """Frames of the shortest input that still gives one pooled
        embedding frame: one fbank window widened by the trunk's 8x time
        reduction (the pipeline's rule), on the segmentation's frames."""
        least = resnet.WINDOW + 7 * resnet.SHIFT
        return math.ceil(num_frames * least / self.window)

    def masks(self, binarized: torch.Tensor) -> torch.Tensor:
        """(C, F, S) hard segmentation -> (C, S, F) pooling masks."""
        if self.config["embedding_exclude_overlap"]:
            alone = binarized.sum(dim=2, keepdim=True) < 2
            clean = binarized * alone
            enough = clean.sum(dim=1, keepdim=True) > self.min_num_frames(
                binarized.shape[1])
            masks = torch.where(enough, clean, binarized)
        else:
            masks = binarized
        return masks.transpose(1, 2)

    def embeddings(self, samples: np.ndarray, binarized: torch.Tensor,
                   num: Numerics) -> torch.Tensor:
        hp = dict(self.config["embedding"]["hparams"],
                  real_samples=len(samples))
        with torch.inference_mode():
            return resnet.embeddings(self.padded(samples),
                                     self.starts(len(samples)), self.window,
                                     self.masks(binarized),
                                     self.weights["embedding"], hp, num)

    # -- clustering and reconstruction ----------------------------------------

    def cluster(self, embeddings: np.ndarray, clean_frames: np.ndarray,
                speaker_frames: np.ndarray, num_frames: int):
        """(hard clusters, the scores they were assigned from)."""
        return self.clusterer(embeddings, clean_frames, speaker_frames,
                              num_frames)

    def grid(self, num_chunks: int):
        step_s = self.step / self.sample_rate
        offsets = reconstruct.frame_offsets(num_chunks, step_s,
                                            self.frame_step)
        frames = reconstruct.num_output_frames(num_chunks, self.duration,
                                               step_s, self.frame_step)
        return offsets, frames

    def count(self, binarized: np.ndarray) -> np.ndarray:
        offsets, frames = self.grid(binarized.shape[0])
        return reconstruct.speaker_count(binarized, offsets, frames)

    def annotation(self, binarized: np.ndarray, hard: np.ndarray,
                   count: np.ndarray, speaker_frames: np.ndarray,
                   exclusive: bool = False):
        hard = np.array(hard, dtype=np.int64)
        hard[speaker_frames == 0] = -2
        offsets, frames = self.grid(binarized.shape[0])
        normal, alone = reconstruct.reconstruct(binarized, hard, count,
                                                offsets, frames)
        return reconstruct.segments(alone if exclusive else normal,
                                    self.frame_duration, self.frame_step,
                                    named=normal)
