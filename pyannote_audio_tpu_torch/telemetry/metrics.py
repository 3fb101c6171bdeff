"""Opt-in anonymous usage telemetry.

Counterpart of pyannote_audio_tpu/telemetry/metrics.py: the same events
(``model_init``, ``pipeline_init``, ``pipeline_apply``) with the same
attributes, appended as JSON lines to a local spool that an exporter
could ship. Off by default; ``PYANNOTE_TPU_METRICS_ENABLED`` (or the
reference's ``PYANNOTE_METRICS_ENABLED``) set to 1 / true / yes / on, or
``set_telemetry_metrics(True)``, turns it on for the process. The spool
is ``PYANNOTE_TPU_METRICS_SPOOL`` (read when an event is written), by
default ``~/.cache/pyannote_audio_tpu/telemetry.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

_STATE = {"enabled": None}


def spool_path() -> Path:
    return Path(os.environ.get(
        "PYANNOTE_TPU_METRICS_SPOOL",
        "~/.cache/pyannote_audio_tpu/telemetry.jsonl")).expanduser()


def telemetry_enabled() -> bool:
    if _STATE["enabled"] is not None:
        return _STATE["enabled"]
    env = os.environ.get("PYANNOTE_TPU_METRICS_ENABLED",
                         os.environ.get("PYANNOTE_METRICS_ENABLED", "0"))
    return env.lower() in ("1", "true", "yes", "on")


def is_metrics_enabled() -> bool:
    """The reference's name for ``telemetry_enabled``."""
    return telemetry_enabled()


def set_telemetry_metrics(enabled: bool,
                          persist: Optional[bool] = None) -> None:
    """Turn telemetry on or off for this process (``persist`` is
    accepted for the reference's signature; nothing is persisted)."""
    _STATE["enabled"] = bool(enabled)


def _emit(event: str, **attributes) -> None:
    if not telemetry_enabled():
        return
    record = {"event": event, "time": time.time(), **attributes}
    try:
        path = spool_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass


def track_model_init(model) -> None:
    _emit("model_init", architecture=type(model).__name__)


def track_pipeline_init(pipeline) -> None:
    _emit("pipeline_init", pipeline=type(pipeline).__name__)


def track_pipeline_apply(pipeline, file, duration: Optional[float] = None,
                         num_speakers: Optional[int] = None,
                         min_speakers: Optional[int] = None,
                         max_speakers: Optional[int] = None) -> None:
    _emit("pipeline_apply", pipeline=type(pipeline).__name__,
          duration=duration, num_speakers=num_speakers,
          min_speakers=min_speakers, max_speakers=max_speakers)


def set_opentelemetry_log_level(level: str) -> None:
    """The spool's logger level (the reference's knob for its OTLP
    backend)."""
    logging.getLogger(__name__).setLevel(
        getattr(logging, str(level).upper(), logging.ERROR))
