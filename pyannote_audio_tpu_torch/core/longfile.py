"""Bounded device memory for files of any length.

Counterpart of pyannote_audio_tpu/core/longfile.py. The accelerator path
holds whole-file device buffers (the shared sinc features, the whole-file
fbank, the trunk panels: utils/flops.py ``diarization_resident_hbm_bytes``),
which grow with the file. Past a budget, a file is processed in slices of
fixed length, each carrying a halo of real audio on both sides. Every
front-end involved is a convolution plus one sliding-window CMN, so a
slice with enough halo gives every chunk it owns the same frames as the
whole file would; only the per-chunk outputs (scores, embeddings) are
gathered across slices.

Slice starts are floored to ALIGN = 12800 samples (0.8 s), a multiple of
the sinc stride (10), the fbank frame shift (160) and 160 x the trunk
stride for every stride dividing 80: slice-local feature grids lie on the
whole-file grids, and chunk starts translate by a constant.

Knobs (the JAX package's names and defaults)
--------------------------------------------
PYANNOTE_TPU_SEGMENT_MINUTES
    unset or "": slice when the resident-memory model exceeds the budget.
    "0": never slice. Any other number: that slice length, for files
    longer than it. Anything else warns and falls back to auto.
PYANNOTE_TPU_HBM_BUDGET_GB
    Resident-buffer budget of auto mode, 6.0 by default (the JAX
    package's default): whole-file buffers up to about 2 h, slices past.
PYANNOTE_TPU_SEGMENT_HALO_SECONDS
    Real audio on each side of a slice, 20 s by default: the 5 s CMN
    half-window, the trunk's receptive field and the fbank window, with
    margin.
"""

from __future__ import annotations

import os
import warnings
from collections.abc import MutableMapping
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..utils.flops import diarization_resident_hbm_bytes

#: a multiple of the sinc stride (10), the fbank frame shift (160) and
#: 160 x every trunk stride dividing 80
ALIGN = 12800

#: bytes per sample of the port's device waveform (float32)
UPLOAD_BYTES_PER_SAMPLE = 4.0


@dataclass(frozen=True)
class Slice:
    """One bounded piece of a long file.

    ``a:b`` are the sample bounds of the halo'd slice in the file's
    waveform; chunks ``i0:i1`` of the global chunk grid are owned by this
    slice and lie inside it (their starts translate by ``-a``).
    """
    a: int
    b: int
    i0: int
    i1: int


def _env_float(name: str, default: float) -> float:
    value = os.environ.get(name, "")
    try:
        return float(value) if value != "" else default
    except ValueError:
        return default


def halo_samples(sample_rate: int) -> int:
    """Halo on each side, rounded up to ALIGN, so that a halo asked for at
    exactly the CMN and receptive-field margin is never cut short."""
    halo = int(_env_float("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", 20.0)
               * sample_rate)
    return max(ALIGN, -(-halo // ALIGN) * ALIGN)


def segment_minutes(file_seconds: float, sample_rate: int = 16000
                    ) -> Optional[float]:
    """Slice length in minutes for a file of this duration, or None for
    whole-file buffers.

    Auto mode takes the longest of a few lengths whose halo'd slice fits
    the budget under the resident-memory model; an explicit
    PYANNOTE_TPU_SEGMENT_MINUTES wins either way.
    """
    forced = os.environ.get("PYANNOTE_TPU_SEGMENT_MINUTES", "")
    if forced != "":
        try:
            minutes = float(forced)
        except ValueError:
            warnings.warn(
                f"PYANNOTE_TPU_SEGMENT_MINUTES={forced!r} is not a "
                "float; falling back to auto slicing")
            minutes = None
        if minutes is not None:
            if minutes <= 0:                  # "0" = never slice
                return None
            return minutes if file_seconds > minutes * 60.0 else None
    budget = _env_float("PYANNOTE_TPU_HBM_BUDGET_GB", 6.0) * 2.0 ** 30
    if diarization_resident_hbm_bytes(file_seconds)["total"] <= budget:
        return None
    halo_sec = 2 * halo_samples(sample_rate) / sample_rate
    for minutes in (60.0, 40.0, 30.0, 20.0, 10.0, 6.0, 4.0, 2.0):
        model = diarization_resident_hbm_bytes(minutes * 60.0 + halo_sec)
        if model["total"] <= budget:
            return minutes
    return 2.0


def plan_slices(num_samples: int, window_size: int, step_size: int,
                sample_rate: int,
                starts: np.ndarray) -> Optional[List[Slice]]:
    """Partition the global chunk grid ``starts`` into halo'd slices, or
    None when the file takes whole-file buffers.

    Every chunk belongs to exactly one slice. A slice's sample range
    carries ``halo_samples`` of real audio on each side, clipped at the
    file's edges (where the whole file sees the same edge), and starts on
    ALIGN.
    """
    minutes = segment_minutes(num_samples / sample_rate, sample_rate)
    if minutes is None:
        return None
    halo = halo_samples(sample_rate)
    seg_samples = int(minutes * 60.0 * sample_rate)
    chunks_per_slice = max(1, seg_samples // step_size)
    num_chunks = len(starts)
    slices: List[Slice] = []
    for i0 in range(0, num_chunks, chunks_per_slice):
        i1 = min(i0 + chunks_per_slice, num_chunks)
        a = max(0, ((int(starts[i0]) - halo) // ALIGN) * ALIGN)
        b = min(num_samples, int(starts[i1 - 1]) + window_size + halo)
        # slice-local sample indices stay within int32, as in the JAX
        # package, whose device gathers take int32 starts
        if int(starts[i1 - 1]) - a + window_size > 2 ** 31 - 1:
            raise ValueError(
                f"slice length {minutes} min exceeds the int32 sample "
                "range of the device gathers (~37 h at 16 kHz); choose "
                "a smaller PYANNOTE_TPU_SEGMENT_MINUTES")
        slices.append(Slice(a=a, b=b, i0=i0, i1=i1))
    return slices


def slice_uploads(file, waveform, slices: List[Slice], sample_rate: int,
                  starts: np.ndarray, window_size: int, device):
    """``(get, release)`` for per-slice device buffers, cached in the file
    dict under ``_longfile_uploads``.

    The segmentation and embedding stages share the cache, so each
    slice's waveform is uploaded once: ``get(k)`` returns slice ``k``'s
    float32 (channel, padded) buffer on ``device``, ``release(k)`` drops
    it. The cache carries the waveform's fingerprint (the rule of
    ``_upload_waveform_cached``): a reused dict whose waveform changed
    starts afresh. A waveform given as a tensor is not cached.

    A slice's buffer is zero-padded to cover ``starts[i1-1] - a +
    window_size``: the last chunk of the last slice may reach past the
    end of the file, as the zero-padded tail chunk of the whole grid does.
    """
    from .inference import _upload_waveform, _waveform_fingerprint

    if isinstance(waveform, torch.Tensor) or \
            not isinstance(file, MutableMapping):
        cache = {}
    else:
        fingerprint = _waveform_fingerprint(waveform)
        cache = file.get("_longfile_uploads")
        if cache is None or cache.get("_fingerprint") != fingerprint:
            cache = {"_fingerprint": fingerprint}
            file["_longfile_uploads"] = cache
    device = torch.device(device)

    def get(k: int):
        sl = slices[k]
        needed = max(sl.b - sl.a,
                     int(starts[sl.i1 - 1]) - sl.a + window_size)
        # keyed by slice index, not only (a, b): with a halo longer than
        # the slice, neighbours can share clipped bounds, and releasing
        # one must not evict the other
        key = (k, sl.a, sl.b, needed, str(device))
        buf = cache.get(key)
        if buf is None:
            buf = _upload_waveform(waveform[:, sl.a:sl.b], device, needed)
            cache[key] = buf
        return buf

    def release(k: int):
        for key in [key for key in cache
                    if isinstance(key, tuple) and key[0] == k]:
            cache.pop(key, None)

    return get, release


def retained_upload_bytes_ok(num_samples: int) -> bool:
    """May the slice path keep every slice's upload between the
    segmentation and the embedding stage?

    Kept, they add up to the whole file (4 bytes per sample, float32),
    which grows with the file's length: the growth this module bounds.
    They are kept only while that total stays within a quarter of the
    budget; past it, the embedding stage uploads each slice again.
    """
    budget = _env_float("PYANNOTE_TPU_HBM_BUDGET_GB", 6.0) * 2.0 ** 30
    return UPLOAD_BYTES_PER_SAMPLE * num_samples <= 0.25 * budget
