"""A configuration that is not a ``SpeakerDiarization`` comes to the
harness as new files alone: this test writes one into a temporary tree
(the port's ``SpeechSeparation`` over a small ToTaToNet without its WavLM
branch, with a plain reference and a check of its own), runs a cell of it
through ``harness.main`` on the CPU, and sees no file of ``portbench/``
written to."""

import hashlib
import json
import textwrap

import pytest
import torch

from portbench import harness
from portbench.control import control
from portbench.harness import ROOT

NAME, CELL = "separation-tiny", "separation-tiny.batch"
SEED = 2 ** 40 + 23

CONFIG = {
    "name": NAME,
    "source": "https://huggingface.co/pyannote/speech-separation-ami-1.0",
    "model": {"encoder_decoder": {"fb_name": "free", "n_filters": 16,
                                  "kernel_size": 32, "stride": 16},
              "dprnn": {"n_repeats": 1, "bn_chan": 16, "hid_size": 8,
                        "chunk_size": 20},
              "linear": {"hidden_size": 8, "num_layers": 2},
              "diar": {"frames_per_second": 125},
              "n_sources": 3, "duration": 2.0, "sample_rate": 16000},
    "segmentation_step": 0.5,
    "segmentation_batch_size": 4,
    "lstm_precision": "default",
    "check_files": 2,
    "control": "fp8",
    "limits": {"source_gap": 1e-4, "score_gap": 1e-4,
               "launches_short": 0, "failed": 0},
}

BENCHMARK = {
    "command": ["python3", "portbench/run.py"],
    "paths": ["portbench"],
    "run_seconds": 10,
    "configs": [{"name": NAME, "source": CONFIG["source"],
                 "file": f"portbench/configs/{NAME}.json",
                 "reduced": ["model"], "why": "ToTaToNet without WavLM"}],
    "workloads": [{"name": CELL, "config": NAME, "traffic": "short",
                   "chips": 1, "why": "lists of two recordings of 3-6 s"}],
    "end_to_end": [
        {"name": "diar_audio_s_per_s", "unit": "audio_s/s",
         "better": "higher", "bound": 0.25, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "separate_host_s_per_audio_h", "unit": "s/audio_h",
         "better": "lower", "source": "program_span",
         "layer": "separation", "moves": "diar_audio_s_per_s"}],
}

# the plain reference: asteroid's free filterbank and DPRNN as PixIT's
# ToTaToNet uses them, without the WavLM branch
REFERENCE = '''
"""Plain ToTaToNet without its WavLM branch, over a state dict under the
port's names."""

import torch
import torch.nn.functional as F

from portbench.reference.pyannet import lstm
from portbench.weights import Leaf


def leaves(m):
    F_, k = m["encoder_decoder"]["n_filters"], m["encoder_decoder"][
        "kernel_size"]
    d, S = m["dprnn"], m["n_sources"]
    C, H = d["bn_chan"], d["hid_size"]

    def uniform(name, shape, fan_in):
        return Leaf(name, shape, ("uniform", fan_in ** -0.5))

    out = [uniform("encoder.filterbank._filters", (F_, 1, k), k),
           uniform("decoder.filterbank._filters", (F_, 1, k), k)]

    def norm(name, width):
        return [Leaf(f"{name}.gamma", (1, width, 1), ("const", 1.0)),
                Leaf(f"{name}.beta", (1, width, 1), ("const", 0.0))]

    out += norm("masker.bottleneck.0", F_)
    out += [uniform("masker.bottleneck.1.weight", (C, F_, 1), F_),
            uniform("masker.bottleneck.1.bias", (C,), F_)]
    for r in range(d["n_repeats"]):
        for side in ("intra", "inter"):
            pre = f"masker.net.{r}.{side}"
            for suffix in ("", "_reverse"):
                for name, shape in (("weight_ih", (4 * H, C)),
                                    ("weight_hh", (4 * H, H)),
                                    ("bias_ih", (4 * H,)),
                                    ("bias_hh", (4 * H,))):
                    out.append(uniform(f"{pre}_RNN.rnn.{name}_l0{suffix}",
                                       shape, H))
            out += [uniform(f"{pre}_linear.weight", (C, 2 * H), 2 * H),
                    uniform(f"{pre}_linear.bias", (C,), 2 * H)]
            out += norm(f"{pre}_norm", C)
    out += [Leaf("masker.first_out.0.weight", (1,), ("const", 0.25)),
            uniform("masker.first_out.1.weight", (S * C, C, 1, 1), C),
            uniform("masker.first_out.1.bias", (S * C,), C)]
    for name in ("net_out.0", "net_gate.0"):
        out += [uniform(f"masker.{name}.weight", (C, C, 1), C),
                uniform(f"masker.{name}.bias", (C,), C)]
    out.append(uniform("masker.mask_net.weight", (F_, C, 1), C))
    width = F_
    for i in range(m["linear"]["num_layers"]):
        out += [uniform(f"linear.{i}.weight", (m["linear"]["hidden_size"],
                                               width), width),
                uniform(f"linear.{i}.bias", (m["linear"]["hidden_size"],),
                        width)]
        width = m["linear"]["hidden_size"]
    out += [uniform("classifier.weight", (1, width), width),
            uniform("classifier.bias", (1,), width)]
    return out


def gln(x, p, name):
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-8) * p[f"{name}.gamma"].reshape(
        -1) + p[f"{name}.beta"].reshape(-1)


def pointwise(x, p, name, bias=True):
    w = p[f"{name}.weight"]
    y = x @ w.reshape(w.shape[0], -1).t()
    return y + p[f"{name}.bias"] if bias else y


def dprnn(x, p, m, num):
    """(B, T, F) -> masks (B, sources, T, F)."""
    d, S = m["dprnn"], m["n_sources"]
    B, T, _ = x.shape
    C, K = d["bn_chan"], d["chunk_size"]
    hop = K // 2
    h = pointwise(gln(x, p, "masker.bottleneck.0"), p, "masker.bottleneck.1")
    h = F.pad(h, (0, 0, K, K))
    Tp = h.shape[1]
    n = (Tp - K) // hop + 1
    chunks = torch.stack([h[:, s * hop:s * hop + K] for s in range(n)], 1)
    for r in range(d["n_repeats"]):
        pre = f"masker.net.{r}"
        y = lstm(chunks.reshape(B * n, K, C), p, f"{pre}.intra_RNN.rnn", 1,
                 num)
        y = pointwise(y, p, f"{pre}.intra_linear").reshape(B, n, K, C)
        chunks = chunks + gln(y, p, f"{pre}.intra_norm")
        y = lstm(chunks.transpose(1, 2).reshape(B * K, n, C), p,
                 f"{pre}.inter_RNN.rnn", 1, num)
        y = pointwise(y, p, f"{pre}.inter_linear").reshape(B, K, n, C)
        chunks = chunks + gln(y.transpose(1, 2), p, f"{pre}.inter_norm")
    a = p["masker.first_out.0.weight"]
    chunks = torch.where(chunks >= 0, chunks, a * chunks)
    chunks = pointwise(chunks, p, "masker.first_out.1").reshape(B, n, K, S, C)
    out = chunks.new_zeros((B, Tp, S, C))
    for s in range(n):
        out[:, s * hop:s * hop + K] += chunks[:, s]
    out = out[:, K:K + T]
    gated = torch.tanh(pointwise(out, p, "masker.net_out.0")) * \\
        torch.sigmoid(pointwise(out, p, "masker.net_gate.0"))
    return torch.relu(pointwise(gated, p, "masker.mask_net", bias=False)
                      ).transpose(1, 2)


def forward(chunks, p, m, num):
    """(B, 1, samples) -> (diarization (B, frames, sources), sources (B,
    samples, sources))."""
    B, _, T = chunks.shape
    stride = m["encoder_decoder"]["stride"]
    S = m["n_sources"]
    with num.flags():
        rep = F.conv1d(chunks, p["encoder.filterbank._filters"],
                       stride=stride).transpose(1, 2)
        masked = dprnn(rep, p, m, num) * rep[:, None]
        dec_in = masked.reshape(B * S, *masked.shape[2:])
        decoded = F.conv_transpose1d(
            dec_in.transpose(1, 2), p["decoder.filterbank._filters"],
            stride=stride)[:, 0].reshape(B, S, -1)
        decoded = F.pad(decoded, (0, max(0, T - decoded.shape[-1])))[..., :T]
        scale = int(m["sample_rate"] / m["diar"]["frames_per_second"]
                    / stride)
        frames = dec_in.shape[1] // scale
        h = dec_in[:, :frames * scale].reshape(B * S, frames, scale, -1) \\
            .mean(dim=2)
        for i in range(m["linear"]["num_layers"]):
            h = F.leaky_relu(h @ p[f"linear.{i}.weight"].t()
                             + p[f"linear.{i}.bias"], 0.01)
        scores = (h @ p["classifier.weight"].t() + p["classifier.bias"])[
            ..., 0].reshape(B, S, frames)
        return torch.sigmoid(scores.transpose(1, 2)), decoded.transpose(1, 2)
'''

MODULE = '''
"""separation-tiny: the port's SpeechSeparation over a small ToTaToNet
without its WavLM branch, held against a plain reference of its own."""

import time
from pathlib import Path

import numpy as np
import torch

from portbench import flops, harness
from portbench.reference.numerics import Numerics
from portbench.traffic.generator import seeded
from portbench.weights import draw, generator

REFERENCE = harness.load_module(
    Path(__file__).resolve().parents[1] / "reference" / "tiny_totatonet.py",
    "portbench_reference_tiny_totatonet")


def draw_weights(ctx):
    return draw(REFERENCE.leaves(ctx.config["model"]),
                generator(ctx.seed, 1, ctx.device), ctx.device)


def build(ctx):
    from pyannote_audio_tpu_torch.models.separation.totatonet import (
        ToTaToNet, default_specifications)
    from pyannote_audio_tpu_torch.pipelines.speech_separation import \\
        SpeechSeparation
    m, config = ctx.config["model"], ctx.config
    weights = draw_weights(ctx)
    model = ToTaToNet(encoder_decoder=m["encoder_decoder"],
                      linear=m["linear"], diar=m["diar"], dprnn=m["dprnn"],
                      n_sources=m["n_sources"], sample_rate=m["sample_rate"],
                      specifications=default_specifications(
                          m["n_sources"], m["duration"]))
    model.load_reference_state_dict(
        {k: v.cpu() for k, v in weights.items()})
    pipeline = SpeechSeparation(
        segmentation=model, segmentation_step=config["segmentation_step"],
        segmentation_batch_size=config["segmentation_batch_size"],
        device=ctx.device)
    return pipeline.instantiate(pipeline.default_parameters()), weights


def install(capture, pipeline):
    def separate(original):
        def run(waveform, sample_rate, file):
            capture.current = file["uri"]
            out = original(waveform, sample_rate, file)
            record = capture.files[capture.current]
            record["scores"], record["sources"] = out[0], out[1]
            return out
        return capture.timed("separate", run)
    capture.wrap(pipeline, "_separate", separate)
    capture.time(pipeline, "clustering", "clustering")
    capture.time(pipeline, "_overlap_add", "overlap_add")


def warmup(traffic, config):
    return [min(traffic.pool, key=lambda r: r.samples)]


def _grid(config, num_samples):
    m = config["model"]
    window = int(round(m["duration"] * m["sample_rate"]))
    step = int(round(config["segmentation_step"] * window))
    chunks, padded = flops.chunk_grid(num_samples, window, step)
    return window, step, chunks, padded


def _dprnn_shape(config):
    """(encoder frames, DPRNN chunks, chunk frames) of one chunk."""
    m = config["model"]
    ed, K = m["encoder_decoder"], m["dprnn"]["chunk_size"]
    window = int(round(m["duration"] * m["sample_rate"]))
    frames = flops.conv1d_out(window, ed["kernel_size"], ed["stride"])
    return frames, (frames + K) // (K // 2) + 1, K


def lstm_launches(config, num_samples):
    """An intra and an inter launch per repeat and batch of chunks."""
    _, _, chunks, _ = _grid(config, num_samples)
    batch = config["segmentation_batch_size"]
    _, n, K = _dprnn_shape(config)
    sizes = [batch] * (chunks // batch) + ([chunks % batch]
                                           if chunks % batch else [])
    return [shape for b in sizes
            for _ in range(config["model"]["dprnn"]["n_repeats"])
            for shape in ((K, b * n), (n, b * K))]


def recording_flops(config, num_samples):
    """The encoder, the DPRNN's BiLSTMs and the decoder, chunk by chunk."""
    m = config["model"]
    ed, d = m["encoder_decoder"], m["dprnn"]
    _, _, chunks, _ = _grid(config, num_samples)
    frames, n, K = _dprnn_shape(config)
    conv = flops.conv1d_flops(frames, ed["kernel_size"], 1, ed["n_filters"])
    rnn = d["n_repeats"] * (
        n * flops.lstm_flops(K, [d["bn_chan"]], d["hid_size"])
        + K * flops.lstm_flops(n, [d["bn_chan"]], d["hid_size"]))
    return {"encoder": chunks * conv, "dprnn": chunks * rnn,
            "decoder": chunks * m["n_sources"] * conv}


def lstm_trace(config, recordings):
    return {"hidden": config["model"]["dprnn"]["hid_size"], "directions": 2,
            "precision": config["lstm_precision"],
            "launches": [shape for r in recordings
                         for shape in lstm_launches(config, r.samples)]}


def well_formed(output):
    annotation = getattr(output, "speaker_diarization", None)
    return hasattr(annotation, "itertracks") and \\
        getattr(output, "sources", None) is not None


def _reference(config, weights, device, audio, num):
    window, step, chunks, padded = _grid(config, len(audio))
    x = torch.zeros(padded, device=device)
    x[:len(audio)] = torch.as_tensor(audio, device=device)
    with torch.inference_mode():
        return REFERENCE.forward(x.unfold(0, window, step)[:chunks, None],
                                 weights, config["model"], num)


def _gaps(scores, sources, theirs):
    ref_scores, ref_sources = theirs
    sources = torch.as_tensor(sources).to(ref_sources.device, torch.float32)
    scores = torch.as_tensor(scores).to(ref_scores.device, torch.float32)
    return {"source_gap": float((sources - ref_sources).abs().max()
                                / ref_sources.abs().max().clamp(min=1e-12)),
            "score_gap": float((scores - ref_scores).abs().max())}


def check(ctx, weights, done, outputs, records):
    finished = [(f["uri"], r) for d in done
                for f, r in zip(d["files"], d["recordings"])
                if f["uri"] in outputs and "sources" in records.get(
                    f["uri"], {})]
    longest = max(range(len(finished)), key=lambda i: finished[i][1].samples)
    rest = [i for i in range(len(finished)) if i != longest]
    count = min(ctx.config["check_files"], len(finished)) - 1
    values = {}
    for i in [longest] + list(seeded(ctx.seed, 3).choice(rest, size=count,
                                                         replace=False)):
        uri, rec = finished[i]
        start = time.perf_counter()
        found = _gaps(records[uri]["scores"], records[uri]["sources"],
                      _reference(ctx.config, weights, ctx.device,
                                 ctx.traffic.audio(rec), Numerics("float32")))
        ctx.log(f"checked {uri} in {time.perf_counter() - start:.3f} s: "
                f"{found}")
        for name, value in found.items():
            values[name] = max(values.get(name, value), value)
    return values


def control(ctx, weights, mode, files=None):
    rec = max(ctx.traffic.pool, key=lambda r: r.samples)
    audio = ctx.traffic.audio(rec)
    low = _reference(ctx.config, weights, ctx.device, audio, Numerics(mode))
    found = _gaps(low[0], low[1], _reference(ctx.config, weights, ctx.device,
                                             audio, Numerics("float32")))
    return [(f"pool_{rec.index:02d}", rec.seconds, found)]
'''

READER = '''
"""Host seconds in ``SpeechSeparation._separate`` per hour of audio."""


def read(trace):
    spans = trace["spans"]
    if spans["audio_s"] <= 0 or "separate" not in spans["seconds"]:
        return None
    return spans["seconds"]["separate"] / (spans["audio_s"] / 3600.0)
'''


def _tree(root):
    files = {"BENCHMARK.json": json.dumps(BENCHMARK, indent=1),
             f"portbench/configs/{NAME}.json": json.dumps(CONFIG, indent=1),
             f"portbench/configs/{NAME}.py": MODULE,
             "portbench/reference/tiny_totatonet.py": REFERENCE,
             "portbench/metrics/separate_host_s_per_audio_h.py": READER}
    for name, text in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).lstrip())
    return root


def _state():
    """Every file under ``portbench/`` but bytecode and build caches, with
    a digest of its bytes."""
    out = {}
    for path in sorted((ROOT / "portbench").rglob("*")):
        parts = path.relative_to(ROOT).parts
        if path.is_file() and "__pycache__" not in parts \
                and ".cache" not in parts:
            out[str(path)] = (path.stat().st_mtime_ns,
                              hashlib.sha256(path.read_bytes()).hexdigest())
    return out


@pytest.fixture
def short_mix(tiny_mix):
    return dict(tiny_mix, pool_files=2, median_minutes=0.08,
                min_minutes=0.05, max_minutes=0.1)


@pytest.fixture
def tree(tmp_path):
    return _tree(tmp_path / "bench")


def _run(capsys, tree, mix, prepare=None, trace=0):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.01", "--trace", str(trace)],
                      device=torch.device("cpu"), prepare=prepare, mix=mix,
                      root=tree)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    return json.loads(out[-1])


def zeroed_source(pipeline):
    """The model's first separated source zeroed where it is produced."""
    model = pipeline._segmentation.model
    original = model.forward

    def forward(*args, **kwargs):
        diarization, sources = original(*args, **kwargs)
        sources = sources.clone()
        sources[..., 0] = 0.0
        return diarization, sources
    model.forward = forward


def test_a_configuration_of_new_files_runs(capsys, tree, short_mix):
    before = _state()
    line = _run(capsys, tree, short_mix)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"source_gap", "score_gap", "failed"}
    assert set(line["metrics"]) == {"diar_audio_s_per_s", "setup_s"}
    assert line["attempted"] >= 2 and line["failed"] == 0
    traced = _run(capsys, tree, short_mix, trace=1)
    assert traced["correct"] is True, traced["checks"]
    assert traced["metrics"]["separate_host_s_per_audio_h"]["value"] > 0
    found = control(CELL, SEED, "fp8", torch.device("cpu"), mix=short_mix,
                    root=tree)
    assert any(found[0][2][name] > CONFIG["limits"][name]
               for name in ("source_gap", "score_gap")), found
    assert _state() == before


def test_a_broken_separation_is_not_correct(capsys, tree, short_mix):
    line = _run(capsys, tree, short_mix, prepare=zeroed_source)
    assert line["correct"] is False
    assert line["checks"]["source_gap"]["value"] > \
        line["checks"]["source_gap"]["limit"]
