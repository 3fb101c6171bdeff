"""Self-hosted diarization REST server (the pyannoteAI API's shape).

Counterpart of pyannote_audio_tpu/serve.py: the upload -> diarize job ->
poll flow of the pyannoteAI web API (which ``pipelines.pyannoteai.client``
speaks), backed by a local pipeline on the CUDA card. Point the SDK at it:

    >>> server = DiarizationServer(pipeline, token="secret")
    >>> server.start()
    >>> sdk = SDK(token="secret")
    >>> sdk._client = Client("secret", base_url=server.api_url)
    >>> output = sdk.apply("audio.wav")

Routes (v1):
  POST /v1/media/input   {"url": "media://KEY"} -> presigned PUT url
  PUT  /upload/KEY       raw audio bytes (any format the pipeline reads)
  POST /v1/diarize       {"url", "numSpeakers", "minSpeakers",
                          "maxSpeakers", "exclusive", ...} -> {"jobId"}
  GET  /v1/jobs/ID       {"status", "output": {"diarization",
                          "exclusiveDiarization"}}

One worker thread drains the job queue: jobs waiting together (up to
``max_batch``, with the same speaker constraints) go through one
pipelined ``apply_batch``. A batch that raises is retried one job at a
time, so that one bad upload fails only its own job. ``counts`` records
the batch runs, the jobs they carried, the single-job runs, the batches
that failed and the jobs retried after them, so a failing batch is seen,
not hidden.
"""

from __future__ import annotations

import hmac
import json
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that clients polling
    every few milliseconds cannot fill. socketserver's backlog is 5: while
    the accept loop waits for the interpreter, a burst of connections
    overflows it, the kernel drops their SYNs, and each client retries
    after 1, 2, 4, ... s, so one poll can outlast a client's 60 s
    timeout."""

    request_queue_size = 1024


class DiarizationServer:
    """Serve a diarization pipeline over the pyannoteAI REST surface.

    Parameters
    ----------
    pipeline : Pipeline
        An instantiated diarization pipeline (apply(file, ...) ->
        DiarizeOutput or Annotation).
    host, port : str, int
        Bind address; port 0 picks a free port (see ``api_url``).
    token : str, optional
        When set, every request must carry ``Authorization: Bearer
        <token>``.
    spool_dir : str, optional
        Where uploaded media is spooled (a temp dir by default).
    """

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None,
                 spool_dir: Optional[str] = None,
                 media_ttl: Optional[float] = 24 * 3600.0):
        self.pipeline = pipeline
        self.token = token
        self.spool = Path(spool_dir or tempfile.mkdtemp(
            prefix="pyannote-serve")).resolve()
        self.spool.mkdir(parents=True, exist_ok=True)
        #: seconds before uploaded media and finished jobs are evicted
        #: (the pyannoteAI API expires media after 24-48 h; None keeps
        #: everything forever — only sensible for short-lived test servers)
        self.media_ttl = media_ttl
        self._media: Dict[str, Path] = {}
        self._media_ts: Dict[str, float] = {}
        #: single-use upload signatures keyed by spool key (presigned
        #: PUTs carry ?sig=... instead of the API bearer header)
        self._presigned: Dict[str, str] = {}
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        #: handler-side sweeps are rate-limited: _purge_expired scans
        #: every job/media entry under the global lock, so running it on
        #: EVERY poll would serialize N pollers behind O(state) scans
        self._purge_every = min(5.0, media_ttl / 4.0) \
            if media_ttl is not None else None
        self._last_purge = 0.0
        self._httpd = _HTTPServer((host, port), self._handler_class())
        self._threads: list = []
        #: batch runs, jobs they carried, single-job runs, failed batches
        #: and the jobs retried one by one after them (worker thread only)
        self.counts = {"batch_runs": 0, "batched_jobs": 0, "single_runs": 0,
                       "batch_failures": 0, "retried_jobs": 0}

    def _spool_path(self, key: str) -> Optional[Path]:
        """Resolve a media key inside the spool; None if it escapes.

        Containment uses commonpath on the resolved target (a bare
        startswith would let ``../<spool-name>-evil/`` through).
        """
        try:
            target = (self.spool / key).resolve()
            if os.path.commonpath([str(self.spool), str(target)]) \
                    != str(self.spool):
                return None
        except ValueError:        # different drives / malformed key
            return None
        return target

    def _maybe_purge(self) -> None:
        """Rate-limited ``_purge_expired`` for the request handlers.
        Direct calls to ``_purge_expired`` stay unthrottled. A benign
        race on ``_last_purge`` at most runs one extra sweep."""
        if self.media_ttl is None:
            return
        now = time.monotonic()
        if now - self._last_purge < self._purge_every:
            return
        self._last_purge = now
        self._purge_expired()

    def _purge_expired(self) -> None:
        """Evict media + finished jobs older than ``media_ttl``."""
        if self.media_ttl is None:
            return
        now = time.time()
        to_unlink = []
        with self._lock:
            # media referenced by an accepted-but-unfinished job must
            # survive the sweep, however old — evicting it would fail a
            # job the server already promised to run
            live = {job["request"].get("url")
                    for job in self._jobs.values()
                    if job.get("status") not in ("succeeded", "failed",
                                                 "canceled")}
            for url, ts in list(self._media_ts.items()):
                if now - ts <= self.media_ttl or url in live:
                    continue
                path = self._media.pop(url, None)
                del self._media_ts[url]
                self._presigned.pop(url[len("media://"):], None)
                if path is not None:
                    to_unlink.append(path)
            for job_id, job in list(self._jobs.items()):
                done = job.get("status") in ("succeeded", "failed",
                                             "canceled")
                if done and now - job.get("ts", now) > self.media_ttl:
                    del self._jobs[job_id]
        # unlink OUTSIDE the lock: a slow filesystem sweep must not
        # stall every handler thread and the worker's status updates
        for path in to_unlink:
            try:
                path.unlink(missing_ok=True)
            except OSError:
                pass

    # -- lifecycle ---------------------------------------------------------

    @property
    def api_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/v1"

    def start(self) -> "DiarizationServer":
        for target in (self._httpd.serve_forever, self._worker):
            thread = threading.Thread(target=target, daemon=True)
            thread.start()
            self._threads.append(thread)
        return self

    def shutdown(self) -> None:
        self._queue.put(None)
        self._httpd.shutdown()
        for thread in self._threads:
            thread.join(timeout=10)

    def __enter__(self) -> "DiarizationServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- job worker --------------------------------------------------------

    #: max queued jobs drained into one pipelined batch apply
    max_batch: int = 8

    def _worker(self) -> None:
        while True:
            job_id = self._queue.get()
            if job_id is None:
                return
            # drain everything already queued (up to max_batch): several
            # waiting jobs ride ONE pipelined apply_batch, so decode,
            # upload and device compute of consecutive files overlap
            batch = [job_id]
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)    # re-post the shutdown token
                    break
                batch.append(nxt)
            with self._lock:
                for jid in batch:
                    self._jobs[jid]["status"] = "processing"
                # repr-keyed: request values are client-controlled JSON
                # and may be unhashable (a dict/list would kill this
                # thread via TypeError otherwise)
                same_kwargs = len({repr(sorted(self._kwargs(
                    self._jobs[jid]["request"]).items()))
                    for jid in batch}) == 1
            if not same_kwargs or len(batch) == 1:
                # one job, or per-job speaker constraints that differ
                for jid in batch:
                    self._run_single(jid)
                continue
            try:
                outputs = self._run_batch(batch)
            except Exception:
                # a batch-level failure (one corrupt upload aborts the
                # shared decode): each job runs alone, so only the bad
                # one fails; counted, so the failure stays visible
                self.counts["batch_failures"] += 1
                for jid in batch:
                    self.counts["retried_jobs"] += 1
                    self._run_single(jid)
                continue
            self.counts["batch_runs"] += 1
            self.counts["batched_jobs"] += len(batch)
            for jid, output in zip(batch, outputs):
                with self._lock:
                    self._jobs[jid]["output"] = output
                    self._jobs[jid]["status"] = "succeeded"
                    # completion stamp: _purge_expired evicts on ts, so a
                    # missing stamp would keep batch-completed jobs alive
                    # forever (unbounded state in a long-running server)
                    self._jobs[jid]["ts"] = time.time()

    def _run_single(self, job_id: str) -> None:
        self.counts["single_runs"] += 1
        self._finish(job_id, lambda: self._run(self._jobs[job_id]["request"]))

    def _finish(self, job_id: str, produce) -> None:
        try:
            output = produce()
            with self._lock:
                self._jobs[job_id]["output"] = output
                self._jobs[job_id]["status"] = "succeeded"
                self._jobs[job_id]["ts"] = time.time()
        except Exception as error:       # job errors -> failed status
            with self._lock:
                self._jobs[job_id]["error"] = \
                    f"{type(error).__name__}: {error}"
                self._jobs[job_id]["status"] = "failed"
                self._jobs[job_id]["ts"] = time.time()

    def _run_batch(self, batch) -> list:
        """Several queued jobs through the pipelined multi-file apply."""
        with self._lock:
            requests = [self._jobs[jid]["request"] for jid in batch]
        files = [str(self._media[r["url"]]) for r in requests]
        kwargs = self._kwargs(requests[0])
        outputs = self.pipeline(files, **kwargs)
        return [self._serialize(o) for o in outputs]

    @staticmethod
    def _kwargs(request: Dict[str, Any]) -> Dict[str, Any]:
        kwargs = {}
        for api_name, ours in (("numSpeakers", "num_speakers"),
                               ("minSpeakers", "min_speakers"),
                               ("maxSpeakers", "max_speakers")):
            if request.get(api_name) is not None:
                kwargs[ours] = request[api_name]
        return kwargs

    def _run(self, request: Dict[str, Any]) -> Dict[str, Any]:
        media_path = self._media[request["url"]]
        output = self.pipeline(str(media_path), **self._kwargs(request))
        return self._serialize(output)

    @staticmethod
    def _serialize(output) -> Dict[str, Any]:
        if hasattr(output, "serialize"):
            data = output.serialize()
            return {"diarization": data["diarization"],
                    "exclusiveDiarization": data["exclusive_diarization"]}
        # plain Annotation (e.g. a VAD pipeline behind the same API)
        turns = [{"start": round(seg.start, 3), "end": round(seg.end, 3),
                  "speaker": label}
                 for seg, _, label in output.itertracks(yield_label=True)]
        return {"diarization": turns, "exclusiveDiarization": turns}

    # -- http --------------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _drain_body(self) -> None:
                """Read and discard any unread request body before
                responding. Closing the connection with unread bytes in
                flight makes the kernel RST it, so a client still
                sending a large body (e.g. a replayed presigned PUT
                that earns an early 401) sees a connection error
                instead of our status — a load-dependent race on
                whether the whole body fit the kernel socket buffers
                (confirmed by http.client dying in send() with a
                ConnectionReset mid-WAV)."""
                if getattr(self, "_body_read", False):
                    return
                self._body_read = True
                try:
                    length = int(self.headers.get("Content-Length",
                                                  0) or 0)
                except ValueError:
                    return
                # cap: reading is a courtesy to legitimate clients (any
                # real audio body fits); an unauthenticated sender of
                # multi-GB bodies gets the old close-with-RST instead of
                # a free byte sink
                length = min(length, 256 << 20)
                while length > 0:
                    chunk = self.rfile.read(min(length, 1 << 20))
                    if not chunk:
                        break
                    length -= len(chunk)

            def _json(self, obj: Dict, code: int = 200) -> None:
                self._drain_body()
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                self._body_read = True
                length = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(length)

            def _authorized(self) -> bool:
                if server.token is None:
                    return True
                header = self.headers.get("Authorization", "")
                if header == f"Bearer {server.token}":
                    return True
                self._json({"error": "unauthorized"}, 401)
                return False

            def do_POST(self):
                self._body_read = False  # new request on this connection
                if not self._authorized():
                    return
                try:
                    payload = json.loads(self._body() or b"{}")
                except json.JSONDecodeError:
                    return self._json({"error": "bad json"}, 400)
                server._maybe_purge()
                if self.path.rstrip("/").endswith("/media/input"):
                    media_url = payload.get("url", "")
                    if not media_url.startswith("media://"):
                        return self._json({"error": "url must be "
                                           "media://..."}, 400)
                    key = media_url[len("media://"):]
                    target = server._spool_path(key)
                    if target is None:
                        return self._json({"error": "bad key"}, 400)
                    sig = uuid.uuid4().hex
                    with server._lock:
                        server._media[media_url] = target
                        server._media_ts[media_url] = time.time()
                        server._presigned[key] = sig
                    host, port = self.server.server_address[:2]
                    # QUERY-signed like real presigned storage URLs: the
                    # uploader must NOT send its API key to the storage
                    # endpoint (clients strip Authorization on this PUT)
                    return self._json(
                        {"url": f"http://{host}:{port}/upload/{key}"
                                f"?sig={sig}"})
                if self.path.rstrip("/").endswith("/diarize"):
                    for field in ("numSpeakers", "minSpeakers",
                                  "maxSpeakers"):
                        value = payload.get(field)
                        if value is not None and (
                                isinstance(value, bool)
                                or not isinstance(value, int)):
                            return self._json(
                                {"error": f"{field} must be an "
                                 "integer"}, 400)
                    media_url = payload.get("url")
                    with server._lock:
                        known = media_url in server._media \
                            and server._media[media_url].exists()
                    if not known:
                        return self._json(
                            {"error": f"unknown media {media_url!r}; "
                             "upload it first"}, 400)
                    job_id = uuid.uuid4().hex[:12]
                    with server._lock:
                        server._jobs[job_id] = {"status": "created",
                                                "request": payload}
                    server._queue.put(job_id)
                    return self._json({"jobId": job_id})
                self._json({"error": "not found"}, 404)

            def do_PUT(self):
                self._body_read = False  # new request on this connection
                from urllib.parse import parse_qs, urlsplit
                split = urlsplit(self.path)
                if not split.path.startswith("/upload/"):
                    if not self._authorized():
                        return
                    return self._json({"error": "not found"}, 404)
                key = split.path[len("/upload/"):]
                sig = parse_qs(split.query).get("sig", [""])[0]
                # presigned single-use signature OR the API bearer header
                # both authorize the upload. Compare-and-pop under ONE
                # lock acquisition: a check-then-pop would let two
                # concurrent PUTs replay the same signature
                with server._lock:
                    expected = server._presigned.get(key)
                    presigned_ok = expected is not None and bool(sig) \
                        and hmac.compare_digest(sig, expected)
                    if presigned_ok:
                        server._presigned.pop(key, None)
                if not presigned_ok and not self._authorized():
                    return
                target = server._spool_path(key)
                if target is None:
                    return self._json({"error": "bad key"}, 400)
                target.parent.mkdir(parents=True, exist_ok=True)
                # atomic replace: a re-upload racing the worker's decode
                # of the same spool path must never expose a torn file
                tmp = target.with_name(
                    f".{target.name}.{uuid.uuid4().hex[:8]}.part")
                tmp.write_bytes(self._body())
                os.replace(tmp, target)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                self._body_read = False  # new request on this connection
                if not self._authorized():
                    return
                # purge on polls too: a long-lived server whose clients
                # only GET after their last POST must still converge to
                # bounded media/job state within one TTL
                server._maybe_purge()
                if "/jobs/" not in self.path:
                    return self._json({"error": "not found"}, 404)
                job_id = self.path.rsplit("/", 1)[-1]
                with server._lock:
                    job = self._jobs_view(job_id)
                if job is None:
                    return self._json({"error": "unknown job"}, 404)
                self._json(job)

            def _jobs_view(self, job_id):
                job = server._jobs.get(job_id)
                if job is None:
                    return None
                view = {"jobId": job_id, "status": job["status"]}
                if "output" in job:
                    view["output"] = job["output"]
                if "error" in job:
                    view["error"] = job["error"]
                return view

            def log_message(self, *args):
                pass

        return Handler
