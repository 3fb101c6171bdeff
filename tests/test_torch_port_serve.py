"""The port's self-hosted server, pyannoteAI client, SDK and ``Local``
against the JAX package's (``tests/test_serve.py``, ``test_serve_load.py``
and ``test_pyannoteai.py`` on the port).

The pipeline is the CLI tests' community-1 style snapshot on the CPU.
Every job's output must equal ``pipeline(file).serialize()`` exactly
(the server serializes the same ``DiarizeOutput``), and the port's
server must return the JAX server's output for the same request. The
JAX client drives the port's server and the port's client drives the JAX
server, so the two speak one API. Jobs queued together ride one ``apply_batch``,
counted on the server, and a batch with a corrupt upload is retried job
by job, counted too, so that only the bad job fails. The HTTP surface
(auth, path escapes, TTL purges, presigned single-use uploads, integer
speaker fields) is held on both servers.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import pyannote_audio_tpu.models.embedding.wespeaker as jax_wespeaker_module
from pyannote_audio_tpu.core.pipeline import Pipeline as JaxPipeline
from pyannote_audio_tpu.pipelines.pyannoteai.client import \
    Client as JaxClient
from pyannote_audio_tpu.serve import DiarizationServer as JaxServer
from pyannote_audio_tpu_torch import Pipeline
from pyannote_audio_tpu_torch.pipelines.pyannoteai import SDK, Local
from pyannote_audio_tpu_torch.pipelines.pyannoteai.client import (
    Client, PyannoteAICanceledJob, PyannoteAIFailedJob)
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    DiarizeOutput
from pyannote_audio_tpu_torch.serve import DiarizationServer
from pyannote_audio_tpu_torch.utils import yaml_subset
from corpus import make_file
from test_pyannoteai import mock_api  # noqa: F401  (a fixture)
from test_torch_port_cli import write_cli_snapshot
from test_torch_port_models import SmallWeSpeaker
from test_torch_port_models import one_torch_thread  # noqa: F401

SERVERS = {"port": DiarizationServer, "jax": JaxServer}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    write_cli_snapshot(root)
    port = Pipeline.from_pretrained(root, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wespeaker_module, "WeSpeakerResNet34", SmallWeSpeaker)
        jax_pipeline = JaxPipeline.from_pretrained(root)
    files = [make_file(root / f"q{i}.wav",
                       [("alice", 0.5, 4.0 + i), ("bob", 5.0, 9.0)],
                       duration=12.0 + i, seed=i)["audio"]
             for i in range(3)]
    return root, port, jax_pipeline, [str(f) for f in files]


_EXPECTED = {}


def expected(pipeline, path):
    """The port pipeline's own output for a file, in the API's names."""
    if path not in _EXPECTED:
        data = pipeline(path).serialize()
        _EXPECTED[path] = {"diarization": data["diarization"],
                          "exclusiveDiarization":
                              data["exclusive_diarization"]}
    return _EXPECTED[path]


def run_queued(server, jobs):
    """Queue ``jobs`` ({job id: media path}) before the worker starts, so
    one drain sees them all; run the worker to its end."""
    for job_id, path in jobs.items():
        media = f"media://{job_id}"
        server._media[media] = path
        server._jobs[job_id] = {"status": "created",
                                "request": {"url": media}}
        server._queue.put(job_id)
    worker = threading.Thread(target=server._worker, daemon=True)
    worker.start()
    server._queue.put(None)
    worker.join(timeout=300)
    assert not worker.is_alive()
    server._httpd.server_close()


def test_sdk_against_the_port_server(setup):
    _, port, _, files = setup
    with DiarizationServer(port, token="tok") as server:
        sdk = SDK(token="tok")
        sdk._client = Client("tok", base_url=server.api_url,
                             poll_interval=0.05, timeout=300.0)
        output = sdk.apply(files[0])
    assert isinstance(output, DiarizeOutput)
    assert output.serialize() == port(files[0]).serialize()
    exclusive = output.exclusive_speaker_diarization
    assert exclusive.get_timeline().support().duration() == pytest.approx(
        sum(s.duration for s in exclusive.get_timeline()), abs=1e-6)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_clients_and_servers_interoperate(setup, client, server):
    _, port, jax_pipeline, files = setup
    pipeline = port if server == "port" else jax_pipeline
    Klient = JaxClient if client == "jax" else Client
    with SERVERS[server](pipeline, token="tok") as running:
        api = Klient("tok", base_url=running.api_url, poll_interval=0.05,
                     timeout=300.0)
        job = api.retrieve(api.diarize(api.upload(files[1]),
                                       max_speakers=3))
    assert job["status"] == "succeeded"
    data = pipeline(files[1], max_speakers=3).serialize()
    assert job["output"] == {"diarization": data["diarization"],
                             "exclusiveDiarization":
                                 data["exclusive_diarization"]}


def test_port_and_jax_servers_return_one_output(setup):
    """The same uploads and requests to both servers: equal job outputs.
    The requests leave the speaker count free (a bound the clustering
    does not reach passes through and changes nothing): past a bound,
    VBx falls back to KMeans, which is scikit-learn's in the JAX package
    and the port's own ``ops/kmeans.py`` here, equal in partition on well
    separated data only."""
    _, port, jax_pipeline, files = setup
    requests = [(files[1], {}), (files[2], {"max_speakers": 20})]
    outputs = {}
    for name, pipeline in (("port", port), ("jax", jax_pipeline)):
        with SERVERS[name](pipeline, token="tok") as running:
            api = Client("tok", base_url=running.api_url, poll_interval=0.05,
                         timeout=300.0)
            jobs = [api.retrieve(api.diarize(api.upload(path), **kwargs))
                    for path, kwargs in requests]
        assert [job["status"] for job in jobs] == ["succeeded"] * 2, name
        outputs[name] = [job["output"] for job in jobs]
    assert outputs["port"] == outputs["jax"]
    assert all(output["diarization"] for output in outputs["port"])


def test_queued_jobs_ride_one_batch(setup):
    _, port, _, files = setup
    server = DiarizationServer(port)
    run_queued(server, {f"job{i}": f for i, f in enumerate(files)})
    assert server.counts == {"batch_runs": 1, "batched_jobs": 3,
                             "single_runs": 0, "batch_failures": 0,
                             "retried_jobs": 0}
    for i, path in enumerate(files):
        job = server._jobs[f"job{i}"]
        assert job["status"] == "succeeded", job.get("error")
        assert job["output"] == expected(port, path)


def test_a_failed_batch_is_retried_job_by_job_and_counted(setup, tmp_path):
    _, port, _, files = setup
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"this is not audio")
    server = DiarizationServer(port)
    run_queued(server, {"good0": files[0], "bad": str(bad),
                        "good2": files[2]})
    assert server.counts == {"batch_runs": 0, "batched_jobs": 0,
                             "single_runs": 3, "batch_failures": 1,
                             "retried_jobs": 3}
    assert server._jobs["bad"]["status"] == "failed"
    assert server._jobs["bad"]["error"]
    for job_id, path in (("good0", files[0]), ("good2", files[2])):
        assert server._jobs[job_id]["status"] == "succeeded"
        assert server._jobs[job_id]["output"] == expected(port, path)


def test_auth_unknown_media_and_failed_jobs(setup):
    _, port, _, _ = setup
    with DiarizationServer(port, token="right") as server:
        wrong = Client("wrong", base_url=server.api_url, poll_interval=0.05)
        with pytest.raises(urllib.error.HTTPError) as err:
            wrong.diarize("media://nope")
        assert err.value.code == 401
        good = Client("right", base_url=server.api_url, poll_interval=0.05)
        with pytest.raises(urllib.error.HTTPError) as err:
            good.diarize("media://never-uploaded")
        assert err.value.code == 400
        job_id = good.diarize(good.upload(b"this is not audio"))
        with pytest.raises(PyannoteAIFailedJob):
            good.retrieve(job_id)
    assert server.counts["single_runs"] == 1


def post(url, payload, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    return urllib.request.Request(url, data=json.dumps(payload).encode(),
                                  headers=headers, method="POST")


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_uploads_stay_in_the_spool(kind):
    with SERVERS[kind](pipeline=None) as server:
        base = server.api_url.rsplit("/v1", 1)[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/upload/../{server.spool.name}evil/f.wav",
                data=b"x", method="PUT"))
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(post(f"{server.api_url}/media/input",
                                        {"url": "media://../../etc/x"}))
        assert err.value.code == 400
        assert urllib.request.urlopen(post(
            f"{server.api_url}/media/input",
            {"url": "media://ok.wav"})).status == 200


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_purge_evicts_finished_state_only(kind, monkeypatch):
    server = SERVERS[kind](pipeline=None, media_ttl=0.05)
    for name, status in (("old", "succeeded"), ("busy", "created")):
        path = server.spool / f"{name}.wav"
        path.write_bytes(b"data")
        server._media[f"media://{name}.wav"] = path
        server._media_ts[f"media://{name}.wav"] = time.time() - 1.0
        server._jobs[name] = {"status": status, "ts": time.time() - 1.0,
                              "request": {"url": f"media://{name}.wav"}}
    server._purge_expired()
    assert "media://old.wav" not in server._media and "old" not in \
        server._jobs and not (server.spool / "old.wav").exists()
    assert "media://busy.wav" in server._media and "busy" in server._jobs
    calls = []
    monkeypatch.setattr(server, "_purge_expired", lambda: calls.append(1))
    server._last_purge = 0.0
    server._maybe_purge()
    server._maybe_purge()
    assert calls == [1]
    server._httpd.server_close()


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_presigned_uploads_are_single_use(kind, setup):
    _, _, _, files = setup
    with SERVERS[kind](pipeline=None, token="tok") as server:
        put_url = json.loads(urllib.request.urlopen(post(
            f"{server.api_url}/media/input", {"url": "media://once.wav"},
            token="tok")).read())["url"]
        with open(files[0], "rb") as f:
            body = f.read()
        assert urllib.request.urlopen(urllib.request.Request(
            put_url, data=body, method="PUT")).status == 200
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                put_url, data=body * 40, method="PUT"))
        assert err.value.code == 401
        assert (server.spool / "once.wav").read_bytes() == body
        assert not list(server.spool.glob(".*part"))


def test_speaker_fields_must_be_integers(setup):
    _, port, _, files = setup
    with DiarizationServer(port) as server:
        api = Client("x", base_url=server.api_url, poll_interval=0.05)
        media = api.upload(files[0])
        for bad in ({"x": 1}, [2], 1.5, True, "3"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(post(
                    f"{server.api_url}/diarize",
                    {"url": media, "numSpeakers": bad}))
            assert err.value.code == 400, bad
        job = api.retrieve(api.diarize(media))
    assert job["output"] == expected(port, files[0])


def test_local_runs_the_pipeline(setup, tmp_path):
    root, port, _, files = setup
    output = Local(port)({"audio": files[2]}, max_speakers=3)
    assert output.serialize() == port(files[2], max_speakers=3).serialize()
    loaded = Local(str(root), device="cpu")
    assert loaded({"audio": files[0]}).serialize() == \
        port(files[0]).serialize()
    config = {"pipeline": {
        "name": "pyannote.audio.pipelines.VoiceActivityDetection",
        "params": {"segmentation": str(root / "segmentation")}},
        "params": {"min_duration_on": 0.0, "min_duration_off": 0.0}}
    yaml_subset.dump_file(config, tmp_path / "config.yaml")
    with pytest.raises(ValueError, match="SpeakerDiarization"):
        Local(str(tmp_path), device="cpu")


def test_sdk_and_client_against_a_mock_api(setup, mock_api,  # noqa: F811
                                           monkeypatch):
    base, state = mock_api
    turns = [{"start": 0.0, "end": 1.5, "speaker": "SPEAKER_00"},
             {"start": 1.2, "end": 3.0, "speaker": "SPEAKER_01"}]
    state["job_result"] = {"status": "succeeded", "output": {
        "diarization": turns, "exclusiveDiarization": turns}}
    _, _, _, files = setup
    sdk = SDK(token="test-key")
    sdk._client = Client("test-key", base_url=base, poll_interval=0.01)
    output = sdk.apply(files[0], num_speakers=2)
    assert output.serialize()["diarization"] == turns
    with open(files[0], "rb") as f:
        assert state["uploaded"] == f.read()
    assert all(a == "Bearer test-key" for a in state["auth"])
    assert state["diarize_payload"]["numSpeakers"] == 2
    assert state["diarize_payload"]["exclusive"] is True
    client = Client("k", base_url=base, poll_interval=0.01)
    assert client.upload(b"A" * 100) != client.upload(b"B" * 100)
    assert client.upload(b"A" * 100) == client.upload(b"A" * 100)
    state["polls"] = 1
    state["job_result"] = {"status": "failed", "error": "boom"}
    with pytest.raises(PyannoteAIFailedJob, match="boom"):
        client.retrieve("job-1")
    state["job_result"] = {"status": "canceled"}
    with pytest.raises(PyannoteAICanceledJob):
        client.retrieve("job-1")
    with pytest.raises(ValueError, match="API key"):
        Client("")
    monkeypatch.delenv("PYANNOTEAI_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="API key"):
        SDK(token=None).apply(files[0])


def test_fast_pollers_always_connect():
    """48 clients polling a job's status every 5 ms for 3 s, each poll a
    new connection, as the pyannoteAI client polls: every connect returns
    in well under a second. A listen backlog that such polling fills
    drops SYNs, and the kernel retries a dropped SYN only after 1, 2, 4,
    ... s (socketserver's backlog of 5 gave connects of 1-5 s here); the
    pollers run in threads joined within 60 s, so a hang fails the test
    instead of stalling the suite."""
    server = DiarizationServer(object(), token="tok").start()
    host, port = server._httpd.server_address[:2]
    stop = time.monotonic() + 3.0
    connects, failures = [], []

    def poll():
        try:
            while time.monotonic() < stop:
                conn = http.client.HTTPConnection(host, port, timeout=30)
                start = time.monotonic()
                conn.connect()
                connects.append(time.monotonic() - start)
                conn.request("GET", "/v1/jobs/none",
                             headers={"Authorization": "Bearer tok"})
                conn.getresponse().read()
                conn.close()
                time.sleep(0.005)
        except OSError as error:
            failures.append(error)

    try:
        pollers = [threading.Thread(target=poll, daemon=True)
                   for _ in range(48)]
        for thread in pollers:
            thread.start()
        for thread in pollers:
            thread.join(timeout=60)
        assert not any(thread.is_alive() for thread in pollers)
    finally:
        server.shutdown()
    assert server._httpd.request_queue_size >= 128
    assert not failures and len(connects) >= 48
    assert max(connects) < 1.0, sorted(connects)[-5:]
