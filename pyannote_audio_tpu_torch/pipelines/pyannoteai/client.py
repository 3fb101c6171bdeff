"""A pyannoteAI web-API client over urllib.

Counterpart of pyannote_audio_tpu/pipelines/pyannoteai/client.py, which
speaks the REST flow of the official ``pyannoteai-sdk`` ``Client``:

1. ``upload``   -- POST {base}/media/input for a presigned PUT url of a
                   ``media://`` object key, then PUT the audio bytes;
2. ``diarize``  -- POST {base}/diarize, which returns the job id;
3. ``retrieve`` -- GET {base}/jobs/{id}, polled until the job ends; a
                   failed or canceled job raises.

The base url is an argument (or PYANNOTEAI_API_BASE_URL), so the flow
runs against a local server (``serve.py``) with no network.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

DEFAULT_BASE_URL = "https://api.pyannote.ai/v1"

#: job states that mean "keep polling"
_PENDING = {"created", "pending", "processing", "running"}


class PyannoteAIFailedJob(RuntimeError):
    """Raised when a pyannoteAI job reports status "failed"."""

    def __init__(self, job_id: str, message: str = ""):
        super().__init__(
            f"pyannoteAI job {job_id} failed" + (f": {message}" if message
                                                 else ""))
        self.job_id = job_id


class PyannoteAICanceledJob(RuntimeError):
    """Raised when a pyannoteAI job reports status "canceled"."""

    def __init__(self, job_id: str):
        super().__init__(f"pyannoteAI job {job_id} was canceled")
        self.job_id = job_id


class Client:
    """Minimal pyannoteAI REST client (upload / diarize / retrieve).

    Parameters
    ----------
    token : str
        pyannoteAI API key (dashboard.pyannote.ai).
    base_url : str, optional
        API root; defaults to PYANNOTEAI_API_BASE_URL or the public
        endpoint.
    poll_interval : float, optional
        Seconds between job-status polls (retrieve).
    timeout : float, optional
        Overall retrieve timeout in seconds; None = poll forever.
    """

    def __init__(self, token: str, base_url: Optional[str] = None,
                 poll_interval: float = 2.0,
                 timeout: Optional[float] = 3600.0):
        if not token:
            raise ValueError(
                "pyannoteAI API key missing: set PYANNOTEAI_API_KEY or "
                "pass token=...")
        self.token = token
        self.base_url = (base_url
                         or os.environ.get("PYANNOTEAI_API_BASE_URL")
                         or DEFAULT_BASE_URL).rstrip("/")
        self.poll_interval = poll_interval
        self.timeout = timeout

    # -- http plumbing -----------------------------------------------------

    #: per-request socket timeout (seconds): a hung connection must not
    #: block forever — retrieve()'s deadline only runs BETWEEN polls
    request_timeout: float = 60.0

    def _request(self, method: str, url: str,
                 payload: Optional[Dict[str, Any]] = None,
                 raw: Optional[bytes] = None,
                 content_type: str = "application/json",
                 authorized: bool = True) -> Dict[str, Any]:
        data = raw if raw is not None else (
            json.dumps(payload).encode() if payload is not None else None)
        request = urllib.request.Request(url, data=data, method=method)
        if authorized:
            request.add_header("Authorization", f"Bearer {self.token}")
        if data is not None:
            request.add_header("Content-Type", content_type)
        with urllib.request.urlopen(
                request, timeout=self.request_timeout) as response:
            body = response.read()
        if not body:
            return {}
        return json.loads(body)

    # -- api surface (pyannoteai.sdk.Client parity) ------------------------

    def upload(self, file) -> str:
        """Upload audio to pyannoteAI temporary storage.

        Accepts a path, a {"audio": path} / in-memory {"waveform",
        "sample_rate"} mapping, or raw bytes; returns the ``media://``
        url to pass to :meth:`diarize`. In-memory waveforms are
        serialized to 16-bit PCM WAV for the wire.
        """
        if isinstance(file, dict):
            if file.get("audio") is None and file.get("waveform") \
                    is not None:
                import tempfile

                from ...core.io import write_wav
                with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                    write_wav(tmp.name, np.asarray(file["waveform"]),
                              int(file["sample_rate"]))
                    payload = Path(tmp.name).read_bytes()
                name = str(file.get("uri", "waveform"))
                return self._upload_payload(payload, name)
            file = file.get("audio", file.get("uri"))
        if file is None:
            raise ValueError(
                "pyannoteAI upload needs a path, raw bytes, or an "
                "AudioFile with 'audio' (path) or 'waveform' + "
                "'sample_rate' keys")
        if isinstance(file, bytes):
            payload, name = file, "audio"
        else:
            path = Path(file)
            payload, name = path.read_bytes(), path.stem
        return self._upload_payload(payload, name)

    def _upload_payload(self, payload: bytes, name: str) -> str:
        # content-addressed key: same-stem/same-size files must not
        # collide (and PYTHONHASHSEED would make hash() non-reproducible)
        digest = hashlib.md5(payload).hexdigest()[:16]
        media_url = f"media://{name}-{digest}"
        # presigned upload url for the object key
        presigned = self._request(
            "POST", f"{self.base_url}/media/input",
            payload={"url": media_url})["url"]
        # presigned URLs are query-signed: sending the API Bearer header
        # both breaks S3-style endpoints ("only one auth mechanism") and
        # leaks the key to the storage host
        self._request("PUT", presigned, raw=payload,
                      content_type="application/octet-stream",
                      authorized=False)
        return media_url

    def diarize(self, media_url: str,
                num_speakers: Optional[int] = None,
                min_speakers: Optional[int] = None,
                max_speakers: Optional[int] = None,
                confidence: bool = False,
                model: str = "precision-2",
                exclusive: bool = False) -> str:
        """Initiate a diarization job; returns its job id."""
        payload: Dict[str, Any] = {"url": media_url, "model": model,
                                   "confidence": confidence,
                                   "exclusive": exclusive}
        if num_speakers is not None:
            payload["numSpeakers"] = num_speakers
        if min_speakers is not None:
            payload["minSpeakers"] = min_speakers
        if max_speakers is not None:
            payload["maxSpeakers"] = max_speakers
        return self._request(
            "POST", f"{self.base_url}/diarize", payload=payload)["jobId"]

    def retrieve(self, job_id: str) -> Dict[str, Any]:
        """Poll the job until it completes; return the full job record.

        Raises PyannoteAIFailedJob / PyannoteAICanceledJob on terminal
        failure states, TimeoutError past ``timeout`` seconds.
        """
        deadline = None if self.timeout is None \
            else time.monotonic() + self.timeout
        while True:
            job = self._request("GET", f"{self.base_url}/jobs/{job_id}")
            status = job.get("status", "")
            if status in _PENDING:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"pyannoteAI job {job_id} still {status} after "
                        f"{self.timeout:g}s")
                time.sleep(self.poll_interval)
                continue
            if status == "canceled":
                raise PyannoteAICanceledJob(job_id)
            if status == "failed":
                raise PyannoteAIFailedJob(
                    job_id, str(job.get("error", "")))
            return job
