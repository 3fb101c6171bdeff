"""A sample file for demos and tests.

Counterpart of pyannote_audio_tpu/sample/__init__.py: ``SAMPLE_FILE`` is a
29-second two-speaker conversation synthesized from a seed (the JAX
package's recipe, the same random draws and turns, so its samples equal
the JAX package's), with its reference annotation and annotated region.
No audio asset ships with the package: the WAV is written on first access
of ``SAMPLE_FILE`` into the package's git-ignored build directory.
"""

from __future__ import annotations

import uuid

import numpy as np

from ..core.annotation import Annotation, Timeline
from ..core.segment import Segment
from ..utils.build import BUILD_DIR

_TURNS = [
    ("speaker_A", 1.0, 4.5),
    ("speaker_B", 5.0, 8.5),
    ("speaker_A", 9.5, 13.0),
    ("speaker_B", 13.5, 17.5),
    ("speaker_A", 18.5, 22.0),
    ("speaker_B", 23.0, 27.5),
]
_DURATION = 29.0
_SAMPLE_RATE = 16000


def _synthesize() -> np.ndarray:
    """(1, samples) float32: noise, and a harmonic voice per turn."""
    rng = np.random.default_rng(1234)
    n = int(_DURATION * _SAMPLE_RATE)
    wav = 0.003 * rng.standard_normal(n).astype(np.float32)
    f0 = {"speaker_A": 130.0, "speaker_B": 235.0}
    for speaker, start, end in _TURNS:
        i0, i1 = int(start * _SAMPLE_RATE), int(end * _SAMPLE_RATE)
        t = np.arange(i1 - i0) / _SAMPLE_RATE
        sig = np.zeros_like(t)
        for h in range(1, 6):
            sig += (1.0 / h) * np.sin(
                2 * np.pi * f0[speaker] * h * t + rng.uniform(0, 2 * np.pi))
        sig *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3.0 * t))
        wav[i0:i1] += (0.2 * sig).astype(np.float32)
    return wav[None]


def _annotation() -> Annotation:
    annotation = Annotation(uri="sample")
    for speaker, start, end in _TURNS:
        segment = Segment(start, end)
        annotation[segment, annotation.new_track(segment)] = speaker
    return annotation


def _build_sample_file() -> dict:
    from ..core.io import write_wav
    path = BUILD_DIR / "sample.wav"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".sample.{uuid.uuid4().hex}.wav")
        write_wav(tmp, _synthesize(), _SAMPLE_RATE)
        tmp.replace(path)
    return {
        "uri": "sample",
        "audio": str(path),
        "annotation": _annotation(),
        "annotated": Timeline([Segment(0.0, _DURATION)], uri="sample"),
    }


def load_stm(file_stm) -> dict:
    """An STM transcription file as ``{session_id: [{"start", "end",
    "text", "speaker"}, ...]}``."""
    session_ids: dict = {}
    with open(file_stm, "r") as stm:
        for line in stm:
            infos = line.strip().split()
            if not infos:
                continue
            session_id, _, speaker, start, end, *words = infos
            session_ids.setdefault(session_id, []).append({
                "start": float(start),
                "end": float(end),
                "text": " ".join(words),
                "speaker": speaker,
            })
    return session_ids


def __getattr__(name: str):
    # SAMPLE_FILE is built on first access, not at import
    if name == "SAMPLE_FILE":
        value = _build_sample_file()
        globals()["SAMPLE_FILE"] = value
        return value
    raise AttributeError(name)


__all__ = ["SAMPLE_FILE", "load_stm"]
