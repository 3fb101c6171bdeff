"""Batch-internal mixing augmentation for diarization training.

Counterpart of pyannote_audio_tpu/augmentation/mix.py: a sample is mixed
with another sample of the same batch when the sum of their active
speaker counts fits in ``max_num_speakers`` (speakers of different chunks
are distinct people), at a random SNR; the other sample's speakers take
the columns the first leaves free. Host numpy, on the collated batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class MixSpeakerDiarization:
    def __init__(self, p: float = 0.5,
                 min_snr_in_db: float = 0.0,
                 max_snr_in_db: float = 5.0,
                 max_num_speakers: Optional[int] = None,
                 seed: Optional[int] = None):
        self.p = p
        self.min_snr_in_db = min_snr_in_db
        self.max_snr_in_db = max_snr_in_db
        self.max_num_speakers = max_num_speakers
        self.rng = np.random.default_rng(seed)

    def __call__(self, X: np.ndarray, y: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """X (batch, ch, samples), y (batch, frames, speakers) binary."""
        batch = X.shape[0]
        X_out, y_out = X.copy(), y.copy()
        speaker_active = y.any(axis=1)              # (batch, speakers)
        num_speakers = speaker_active.sum(axis=1)   # (batch,)
        # by default the batch's actual max speaker count, not the
        # label-column capacity
        max_speakers = self.max_num_speakers or int(num_speakers.max())
        for i in range(batch):
            if self.rng.uniform() >= self.p:
                continue
            # candidates constrained by the SUM of speaker counts
            # (different chunks = distinct people)
            ok = np.where(
                (num_speakers + num_speakers[i] <= max_speakers)
                & (num_speakers + num_speakers[i] <= y.shape[-1]))[0]
            ok = ok[ok != i]
            if len(ok) == 0:
                continue
            j = int(self.rng.choice(ok))
            snr = self.rng.uniform(self.min_snr_in_db, self.max_snr_in_db)
            p_i = np.mean(X[i] ** 2) + 1e-12
            p_j = np.mean(X[j] ** 2) + 1e-12
            gain = np.sqrt(p_i / p_j) * 10.0 ** (-snr / 20.0)
            X_out[i] = X[i] + gain * X[j]
            # sample j's speakers are DISTINCT people: place them in
            # columns sample i leaves free (training targets left-align
            # local speakers, so plain positional max would merge two
            # different people into one label)
            cols_j = np.where(speaker_active[j])[0]
            free = np.where(~speaker_active[i])[0]
            for c_j, c_free in zip(cols_j, free):
                y_out[i][:, c_free] = np.maximum(y_out[i][:, c_free],
                                                 y[j][:, c_j])
        return X_out, y_out
