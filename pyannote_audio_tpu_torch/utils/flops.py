"""Analytic model of the device memory one file pins while in flight.

Counterpart of ``diarization_resident_hbm_bytes`` in
pyannote_audio_tpu/utils/flops.py, with the constants it needs. The long-
file slice plan (core/longfile.py) reads it, so it is kept term for term
with the JAX package's: the same file then gets the same slice plan in
both packages.
"""

from __future__ import annotations

from typing import Dict

SINC_KERNEL = 251
SINC_FILTERS = 80


def conv1d_out(n: int, kernel: int, stride: int = 1) -> int:
    """VALID conv / pool output length."""
    return (n - kernel) // stride + 1 if n >= kernel else 0


def diarization_resident_hbm_bytes(
        file_seconds: float,
        sample_rate: int = 16000,
        window: float = 10.0,
        step: float = 1.0,
        trunk_stride: int = 8,
        fixed_bytes: int = 192 * 1024 * 1024,
) -> Dict[str, int]:
    """Named whole-file device buffers of one file on the accelerator path
    (shared sinc front-end, whole-file fbank and trunk panels), plus a
    fixed term for the parameters and one 256-chunk working batch.

    Per-kernel scratch is not modelled: the number is the floor that the
    whole-file design pins, which is what bounds the longest file taken
    whole. The waveform terms are the JAX package's upload (float32 plus
    the int16 buffer of its quantized transport); the port's own whole-
    file waveform costs about the same (a float32 upload and its
    grid-padded copy).
    """
    n = int(file_seconds * sample_rate)
    win = int(window * sample_rate)
    hop = int(step * sample_rate)
    num_full = 1 + (n - win) // hop if n >= win else 0
    has_last = (n < win) or ((n - win) % hop > 0)
    n_chunks = num_full + int(has_last)
    needed = (n_chunks - 1) * hop + win
    bucket = 30 * sample_rate
    padded = max(needed, -(-needed // bucket) * bucket)

    sinc_frames = conv1d_out(padded, SINC_KERNEL, 10)
    fbank_frames = conv1d_out(padded, 400, 160)
    trunk_frames = -(-fbank_frames // trunk_stride)
    terms = {
        "waveform_f32": padded * 4,
        "waveform_int16": padded * 2,
        # shared sinc conv features, 80 filters f32 at stride 10
        "sinc_features": sinc_frames * SINC_FILTERS * 4,
        # whole-file log-mel fbank, 80 bins f32
        "fbank": fbank_frames * 80 * 4,
        # whole-file ResNet trunk: 256 channels x 10 freq = 2560 f32
        "trunk_panels": trunk_frames * 2560 * 4,
        # parameters + one 256-chunk gathered batch (256 x 10 s x f32)
        "fixed": fixed_bytes + 256 * win * 4,
    }
    terms["total"] = sum(terms.values())
    return terms
