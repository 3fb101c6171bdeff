"""Hub resolution and the small utilities of the port, against the JAX
package's modules on the same inputs.

Hub downloads are served by ``http.server`` on 127.0.0.1 (the
``HF_ENDPOINT`` of each test), and every test that names a hub id sets
``PYANNOTE_TPU_HUB``, ``PYANNOTE_TPU_CACHE`` and ``HF_ENDPOINT`` itself,
so nothing leaves the machine. Held: the same file bytes, cache paths,
headers and errors as the JAX ``utils/hf_hub.py`` (404, a download cut
short, a token); a pipeline loaded from a hub id, through snapshot roots
or over HTTP into an empty cache, gives the Annotations of the one loaded
from its directory; ``probe``'s LSTM activation within the port's PyanNet
bound of 2e-4; ``map_with_specifications``, ``check_dependencies`` and
the telemetry spool equal to the JAX modules'.
"""

import http.client
import http.server
import json
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pyannote_audio_tpu.utils import hf_hub as jax_hub
from pyannote_audio_tpu_torch.utils import hf_hub

SR = 16000


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class HubServer:
    """The hub's ``/{repo}/resolve/{revision}/{file}`` over files under
    ``root/{repo}/``, on 127.0.0.1; ``requests`` records (path,
    Authorization) pairs; ``/cut/...`` announces more bytes than it
    sends and closes, ``/stall/...`` sends some and waits."""

    def __init__(self, root: Path):
        self.root, self.requests = root, []
        self.release = threading.Event()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                server.requests.append(
                    (self.path, self.headers.get("Authorization")))
                parts = self.path.strip("/").split("/")
                if parts[0] in ("cut", "stall"):
                    self.send_response(200)
                    self.send_header("Content-Length", "1000")
                    self.end_headers()
                    self.wfile.write(b"x" * 10)
                    self.wfile.flush()
                    if parts[0] == "stall":
                        server.release.wait(10.0)
                    return
                if len(parts) < 5 or parts[2] != "resolve":
                    self.send_error(404)
                    return
                path = server.root.joinpath(parts[0], parts[1], *parts[4:])
                if not path.is_file():
                    self.send_error(404)
                    return
                data = path.read_bytes()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.release.set()
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """A served hub root with one repo of two files, an empty cache, no
    snapshot roots."""
    root = tmp_path / "served"
    (root / "org" / "repo" / "sub").mkdir(parents=True)
    (root / "org" / "repo" / "config.yaml").write_text("a: 1\n")
    (root / "org" / "repo" / "sub" / "weights.bin").write_bytes(
        bytes(range(256)) * 5)
    server = HubServer(root)
    monkeypatch.setenv("HF_ENDPOINT", server.endpoint)
    monkeypatch.setenv("PYANNOTE_TPU_HUB", "")
    monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path / "cache"))
    for var in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    yield server, tmp_path
    server.close()


# -- hf_hub --------------------------------------------------------------------------

def test_hub_helpers_equal_jax(monkeypatch, tmp_path):
    for model_id in ("org/name", "name", "./x", "/abs/path", "a/b/c",
                     "org/na me", "org/name.v2"):
        assert hf_hub.looks_like_hub_id(model_id) == \
            jax_hub.looks_like_hub_id(model_id), model_id
    monkeypatch.setenv("PYANNOTE_TPU_HUB", f"{tmp_path}/a:{tmp_path}/b")
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9/")
    monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path / "c"))
    assert hf_hub.hub_roots() == jax_hub.hub_roots()
    assert hf_hub.hub_endpoint() == jax_hub.hub_endpoint()
    assert hf_hub.hub_cache_dir() == jax_hub.hub_cache_dir()
    assert [a.value for a in hf_hub.AssetFileName] == \
        ["calibration.safetensors", "pytorch_model.bin", "config.yaml"]
    (tmp_path / "b" / "org" / "name" / "sub").mkdir(parents=True)
    for args in (("org/name",), ("org/name", "sub")):
        assert hf_hub.resolve_checkpoint(*args) == \
            jax_hub.resolve_checkpoint(*args)
    for module in (hf_hub, jax_hub):
        with pytest.raises(FileNotFoundError, match="cannot resolve"):
            module.resolve_checkpoint("org/missing")
        # a bare name never becomes a download
        with pytest.raises(FileNotFoundError, match="org/name id shape"):
            module.download_from_hf_hub("missing", "config.yaml")


def test_download_equals_jax(hub):
    server, tmp_path = hub
    files = {}
    for name, module in (("port", hf_hub), ("jax", jax_hub)):
        cache = tmp_path / f"cache_{name}"
        files[name] = [
            module.download_from_hf_hub("org/repo", "config.yaml",
                                        cache_dir=cache),
            module.download_from_hf_hub("org/repo", "weights.bin",
                                        subfolder="sub", revision="v1",
                                        token="hf_secret", cache_dir=cache),
        ]
        for path in files[name]:
            assert path.is_file()
        files[name] = [(p.relative_to(cache), p.read_bytes())
                       for p in files[name]]
    assert files["port"] == files["jax"]
    assert files["port"][1][0] == Path("org--repo/v1/sub/weights.bin")
    # the same requests, the token sent as a bearer header
    port_requests, jax_requests = server.requests[:2], server.requests[2:]
    assert port_requests == jax_requests == [
        ("/org/repo/resolve/main/config.yaml", None),
        ("/org/repo/resolve/v1/sub/weights.bin", "Bearer hf_secret")]
    # a cached file is served without a request; a key that is no hub
    # token ("hf_" prefix) is never sent
    assert hf_hub.download_from_hf_hub(
        "org/repo", "config.yaml", cache_dir=tmp_path / "cache_port"
    ).read_text() == "a: 1\n"
    hf_hub.download_from_hf_hub("org/repo", "config.yaml", token="pyannoteAI",
                                revision="r2")
    assert len(server.requests) == 5 and server.requests[-1][1] is None


def test_download_errors_equal_jax(hub, monkeypatch):
    server, tmp_path = hub
    monkeypatch.setenv("PYANNOTE_TPU_HUB_TIMEOUT", "0.5")
    for module in (hf_hub, jax_hub):
        name = module.__name__.split(".")[0]
        with pytest.raises(FileNotFoundError, match="not found in hub repo"):
            module.download_from_hf_hub("org/repo", "missing.bin")
        # a download that stalls part-way times out, and leaves no file
        # and no .part behind
        cache = tmp_path / f"stall_{name}"
        with pytest.raises(TimeoutError):
            module.download_from_hf_hub("stall/repo", "file.bin",
                                        cache_dir=cache)
        assert [p for p in cache.rglob("*") if p.is_file()] == []
    # a connection closed before its Content-Length: the port raises and
    # keeps nothing; the JAX package publishes the torn file (a fault of
    # its own, kept out of the port)
    with pytest.raises(http.client.IncompleteRead):
        hf_hub.download_from_hf_hub("cut/repo", "file.bin",
                                    cache_dir=tmp_path / "cut_port")
    assert [p for p in (tmp_path / "cut_port").rglob("*")
            if p.is_file()] == []
    torn = jax_hub.download_from_hf_hub("cut/repo", "file.bin",
                                        cache_dir=tmp_path / "cut_jax")
    assert torn.read_bytes() == b"x" * 10
    # an unreachable endpoint is a FileNotFoundError in both
    server.close()
    for module in (hf_hub, jax_hub):
        with pytest.raises(FileNotFoundError, match="unreachable"):
            module.download_from_hf_hub("org/repo", "other.yaml")


# -- hub ids through the loaders ---------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A community-1 style snapshot (tests/test_torch_port_cli.py's) with
    a calibration beside it, and a 20 s file."""
    from corpus import default_two_speaker_file
    from test_torch_port_calibration import fit_both
    from test_torch_port_cli import write_cli_snapshot
    root = tmp_path_factory.mktemp("hub_snapshot")
    repo = root / "pyannote" / "speaker-diarization-community-1"
    repo.mkdir(parents=True)
    frame = write_cli_snapshot(repo)
    (repo / "calib").mkdir()
    fit_both(seed=12)[0].save(repo / "calib" / "calibration.safetensors")
    default_two_speaker_file(root / "f.wav")
    return root, repo, frame


def _load_and_apply(model_id, audio):
    from pyannote_audio_tpu_torch.core.pipeline import Pipeline
    pipeline = Pipeline.from_pretrained(model_id, device="cpu")
    return pipeline({"audio": str(audio), "uri": "f"})


def test_pipeline_and_models_from_hub_ids(snapshot, tmp_path, monkeypatch):
    """``Pipeline.from_pretrained``, ``Model.from_pretrained``, PLDA,
    calibration and the CLI's ``download`` on a hub id: through a
    ``PYANNOTE_TPU_HUB`` root, then over HTTP into an empty cache; each
    equals the local load."""
    from pyannote_audio_tpu_torch.__main__ import main
    from pyannote_audio_tpu_torch.core.calibration import Calibration
    from pyannote_audio_tpu_torch.core.model import Model
    from pyannote_audio_tpu_torch.core.plda import PLDA
    from test_torch_port_pipeline import _assert_same_annotation
    root, repo, frame = snapshot
    hub_id = "pyannote/speaker-diarization-community-1"
    expected = _load_and_apply(repo, root / "f.wav")
    local_model = Model.from_pretrained(repo / "segmentation")
    local_plda = PLDA.from_pretrained(repo, subfolder="plda")
    scores = np.linspace(-1.0, 1.0, 9)
    local_calibration = Calibration.from_pretrained(repo, "calib")
    monkeypatch.setenv("PYANNOTE_TPU_HUB", str(root))
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")
    for route in ("roots", "http"):
        if route == "http":
            server = HubServer(root)
            monkeypatch.setenv("HF_ENDPOINT", server.endpoint)
            monkeypatch.setenv("PYANNOTE_TPU_HUB", "")
        monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path / route))
        try:
            ours = _load_and_apply(hub_id, root / "f.wav")
            model = Model.from_pretrained(hub_id, subfolder="segmentation")
            plda = PLDA.from_pretrained(hub_id, subfolder="plda")
            calibration = Calibration.from_pretrained(hub_id, "calib")
            assert main(["download", hub_id, "--device", "cpu"]) == 0
        finally:
            if route == "http":
                server.close()
        assert ours.speaker_diarization.labels() == \
            expected.speaker_diarization.labels()
        _assert_same_annotation(ours.speaker_diarization,
                                expected.speaker_diarization, 0.0)
        for (name, p), q in zip(model.state_dict().items(),
                                local_model.state_dict().values()):
            assert torch.equal(p, q), name
        np.testing.assert_array_equal(plda.lda, local_plda.lda)
        np.testing.assert_array_equal(calibration.transform(scores),
                                      local_calibration.transform(scores))
        if route == "http":
            cached = tmp_path / "http" / "pyannote--speaker-diarization-" \
                "community-1" / "main"
            assert (cached / "config.yaml").is_file()
            assert (cached / "segmentation" / "pytorch_model.bin").is_file()
            assert (cached / "plda" / "plda.npz").is_file()
            requested = {path for path, _ in server.requests}
            assert f"/{hub_id}/resolve/main/embedding/pytorch_model.bin" \
                in requested


def test_hub_ids_follow_the_jax_resolution(snapshot, tmp_path, monkeypatch):
    """The asset paths both packages resolve for the same hub id through
    the same snapshot roots."""
    root, repo, _ = snapshot
    monkeypatch.setenv("PYANNOTE_TPU_HUB", str(root))
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")
    monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path))
    hub_id = "pyannote/speaker-diarization-community-1"
    for asset, subfolder in ((hf_hub.AssetFileName.Pipeline, None),
                             ("plda.npz", "plda"),
                             ("pytorch_model.bin", "embedding")):
        name = asset.value if hasattr(asset, "value") else asset
        assert hf_hub.download_from_hf_hub(hub_id, asset,
                                           subfolder=subfolder) == \
            jax_hub.download_from_hf_hub(hub_id, name, subfolder=subfolder)
    assert hf_hub.hub_asset(repo, "config.yaml") is None
    with pytest.raises(ValueError, match="hub id"):
        hf_hub.hub_asset("pyannote/missing", "config.yaml")


# -- probe, multi-task, dependencies, telemetry, preview ---------------------------------

def test_probe_matches_jax():
    from pyannote_audio_tpu.utils.probe import probe as jax_probe
    from pyannote_audio_tpu_torch.utils.probe import probe
    from test_torch_port_inference import (MODEL_TOL, jax_segmenter,
                                           torch_segmenter_from, wave)
    jax_model = jax_segmenter(powerset=True, seed=4, layers=2)
    port = torch_segmenter_from(jax_model)
    wav = np.stack([wave(2.0, seed=s) for s in (5, 6)])
    output, taps = probe(port, ["lstm"])(wav)
    jax_output, jax_taps = jax_probe(jax_model, ["lstm"])(wav)
    assert list(taps) == ["lstm"]
    np.testing.assert_allclose(output.numpy(), np.asarray(jax_output),
                               atol=MODEL_TOL)
    # the JAX capture of the whole bidirectional stack's output
    jax_lstm = [np.asarray(v) for k, v in jax_taps.items()
                if np.asarray(v).shape == tuple(taps["lstm"].shape)]
    assert jax_lstm
    assert min(np.abs(taps["lstm"].numpy() - v).max()
               for v in jax_lstm) <= MODEL_TOL
    # the hooks are gone afterwards
    assert all(not m._forward_hooks for m in port.modules())


def test_map_with_specifications_matches_jax():
    from pyannote_audio_tpu.core import model as jax_model
    from pyannote_audio_tpu.utils.multi_task import \
        map_with_specifications as jax_map
    from pyannote_audio_tpu_torch.core import model
    from pyannote_audio_tpu_torch.utils.multi_task import \
        map_with_specifications

    def func(spec, *items):
        return (spec.duration, tuple(spec.classes), items)

    def run(module, mapper):
        def make(**kwargs):
            return module.Specifications(
                problem=module.Problem.MULTI_LABEL_CLASSIFICATION,
                resolution=module.Resolution.FRAME, **kwargs)
        one = make(duration=5.0, classes=["a"])
        two = (make(duration=5.0, classes=["a"]),
               make(duration=2.0, classes=["b", "c"]))
        return (mapper(one, func, [1, 2], "x"),
                mapper(two, func, [1, 2], "xy"))
    ours = run(model, map_with_specifications)
    assert ours == run(jax_model, jax_map)
    assert ours[1] == ((5.0, ("a",), (1, "x")), (2.0, ("b", "c"), (2, "y")))


@pytest.mark.parametrize("dependencies,strict", [
    ({"numpy": np.__version__}, False),
    ({"numpy": "0.0.1"}, False),
    ({"numpy": "0.0.1"}, True),
    ({"numpy": np.__version__.split(".")[0] + ".999.0"}, True),
    ({"a_package_that_is_not_installed": "1.0"}, False),
    ({"a_package_that_is_not_installed": "1.0"}, True),
])
def test_check_dependencies_matches_jax(dependencies, strict):
    from pyannote_audio_tpu.utils import dependencies as jax_deps
    from pyannote_audio_tpu_torch.utils import dependencies as deps
    outcomes = []
    for module in (deps, jax_deps):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                module.check_dependencies(dependencies, strict=strict)
                raised = None
            except module.DependencyError as error:
                raised = (type(error).__name__, str(error))
        outcomes.append((raised, [str(w.message) for w in caught]))
    assert outcomes[0] == outcomes[1]
    import pyannote_audio_tpu_torch
    assert deps.installed_version("pyannote_audio_tpu_torch") == \
        pyannote_audio_tpu_torch.__version__


def test_telemetry_spool_matches_jax(tmp_path, monkeypatch):
    from pyannote_audio_tpu.core.pipeline import Pipeline as JaxPipeline
    from pyannote_audio_tpu.telemetry import metrics as jax_metrics
    from pyannote_audio_tpu_torch import telemetry
    from pyannote_audio_tpu_torch.core.pipeline import Pipeline
    from pyannote_audio_tpu_torch.telemetry import metrics
    monkeypatch.setattr(jax_metrics, "_SPOOL", tmp_path / "jax.jsonl")
    monkeypatch.setenv("PYANNOTE_TPU_METRICS_SPOOL",
                       str(tmp_path / "port.jsonl"))
    monkeypatch.setattr(metrics, "_STATE", {"enabled": None})
    monkeypatch.setattr(jax_metrics, "_STATE", {"enabled": None})
    monkeypatch.delenv("PYANNOTE_TPU_METRICS_ENABLED", raising=False)
    monkeypatch.delenv("PYANNOTE_METRICS_ENABLED", raising=False)
    assert not telemetry.telemetry_enabled()
    metrics.track_model_init(torch.nn.Linear(1, 1))
    assert not (tmp_path / "port.jsonl").exists()

    class Echo:
        """A pipeline of each package that returns its file."""
        instantiated = True

        def apply(self, file, hook=None, **kwargs):
            return file["uri"]
    PortEcho = type("Echo", (Echo, Pipeline), {})
    JaxEcho = type("Echo", (Echo, JaxPipeline), {})
    for value in ("1", "yes"):
        monkeypatch.setenv("PYANNOTE_METRICS_ENABLED", value)
        assert telemetry.telemetry_enabled() == \
            jax_metrics.telemetry_enabled() is True
    for module in (metrics, jax_metrics):
        module.track_model_init(torch.nn.Linear(1, 1))
        module.track_pipeline_init(PortEcho())
    file = {"waveform": np.zeros((1, SR), np.float32), "sample_rate": SR,
            "uri": "a"}
    assert PortEcho()(dict(file), num_speakers=2, max_speakers=3) == "a"
    assert JaxEcho()(dict(file), num_speakers=2, max_speakers=3) == "a"

    def events(path):
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in path.read_text().splitlines()]
    ours, theirs = events(tmp_path / "port.jsonl"), \
        events(tmp_path / "jax.jsonl")
    assert ours == theirs and len(ours) == 3
    assert ours[-1] == {"event": "pipeline_apply", "pipeline": "Echo",
                        "duration": None, "num_speakers": 2,
                        "min_speakers": None, "max_speakers": 3}
    telemetry.set_telemetry_metrics(False)
    assert not metrics.is_metrics_enabled()


def test_preview_and_listen_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from pyannote_audio_tpu.core.annotation import Annotation as JaxAnnotation
    from pyannote_audio_tpu.core.segment import Segment as JaxSegment
    from pyannote_audio_tpu.utils import preview as jax_preview
    from pyannote_audio_tpu_torch.core.annotation import Annotation
    from pyannote_audio_tpu_torch.core.io import write_wav
    from pyannote_audio_tpu_torch.core.segment import Segment
    from pyannote_audio_tpu_torch.utils import preview
    wav = (0.1 * np.random.default_rng(0).standard_normal((1, 3 * SR))
           ).astype(np.float32)
    write_wav(tmp_path / "a.wav", wav, SR)
    figures = []
    for module, Ann, Seg in ((preview, Annotation, Segment),
                             (jax_preview, JaxAnnotation, JaxSegment)):
        annotation = Ann(uri="a")
        annotation[Seg(0.5, 1.5)] = "A"
        annotation[Seg(1.0, 2.5)] = "B"
        fig = module.preview(str(tmp_path / "a.wav"), Seg(0.0, 3.0),
                             annotation)
        figures.append([(tuple(ax.get_yticks()),
                         [t.get_text() for t in ax.get_yticklabels()],
                         ax.get_xlim()) for ax in fig.axes])
        heard = module.listen(str(tmp_path / "a.wav"), Seg(1.0, 2.0))
        assert type(heard).__name__ in ("Audio", "tuple")
    assert figures[0] == figures[1]
    path = preview.preview_video(str(tmp_path / "a.wav"), Segment(0.0, 1.0),
                                 zoom=0.5, display=False,
                                 speech=annotation_of(Annotation, Segment))
    assert Path(path).stat().st_size > 0


def annotation_of(Ann, Seg):
    annotation = Ann(uri="a")
    annotation[Seg(0.2, 0.8)] = "A"
    return annotation
