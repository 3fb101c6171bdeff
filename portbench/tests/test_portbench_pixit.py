"""The ``pixit-wavlm-large`` configuration's module on the CPU, at tiny
sizes written to a temporary tree (as ``test_portbench_room.py`` writes
its configuration): the module file itself, under a tiny configuration of
the same keys (WavLM of 2 layers x 32, a DPRNN of one repeat, a ResNet of
one block a stage, 2-s chunks).

Held: a cell runs through ``harness.main`` and is correct, untraced and
traced (the three new readers there, the host one with a value), and no
file of ``portbench/`` is written; the control, one precision below, is
not correct by some limit; the module's ``lstm_launches`` are the (T, B)
of every recurrence a run launches; ``recording_flops``' ToTaToNet
stages are what ``FlopCounterMode`` counts over the plain model; a zeroed
source or swapped clusters make ``correct`` false; the reference's
leakage mask is scipy's ``binary_dilation``.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from portbench import flops, harness
from portbench.control import control
from portbench.harness import ROOT
from portbench.reference import totatonet
from portbench.reference.numerics import Numerics
from portbench.weights import draw, generator

NAME, CELL = "pixit-tiny", "pixit-tiny.separate"
SEED = 2 ** 40 + 41
# the shared fbank and trunk, as on the card
pytestmark = pytest.mark.usefixtures("accelerator_semantics")
READERS = ("wavlm_device_ms_per_audio_min", "dprnn_device_ms_per_audio_min",
           "sep_post_host_s_per_audio_h")


def tiny_config() -> dict:
    config = json.loads((ROOT / "portbench" / "configs"
                         / "pixit-wavlm-large.json").read_text())
    config["name"] = NAME
    seg = config["segmentation"]
    seg["hparams"].update(
        encoder_decoder=dict(seg["hparams"]["encoder_decoder"],
                             n_filters=16),
        dprnn=dict(seg["hparams"]["dprnn"], n_repeats=1, bn_chan=16,
                   hid_size=8, chunk_size=20),
        linear={"hidden_size": 8, "num_layers": 2})
    seg["ssl"].update(hidden=32, layers=2, heads=4, ffn=64, conv_channels=16,
                      conv_layers=[[16, k, s] for _, k, s in
                                   seg["ssl"]["conv_layers"]])
    seg["specifications"]["duration"] = 2.0
    config["embedding"]["hparams"].update(num_blocks=[1, 1, 1, 1],
                                          m_channels=8, embed_dim=16,
                                          compute_dtype="float32")
    config["segmentation_batch_size"] = 8
    config["embedding_batch_size"] = 8
    # a lower threshold than the published one: tiny embeddings, and the
    # swapped-clusters case needs recordings of several clusters
    config["instantiate"]["clustering"].update(threshold=0.3,
                                               min_cluster_size=2)
    config["instantiate"]["separation"]["asr_collar"] = 0.05
    return config


def benchmark() -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {
        "command": bench["command"], "paths": bench["paths"],
        "run_seconds": 10,
        "configs": [{"name": NAME, "source": tiny_config()["source"],
                     "file": f"portbench/configs/{NAME}.json",
                     "reduced": ["segmentation", "embedding"],
                     "why": "tiny ToTaToNet with WavLM"}],
        "workloads": [{"name": CELL, "config": NAME, "traffic": "short",
                       "chips": 1, "why": "lists of two short recordings"}],
        "end_to_end": bench["end_to_end"],
        "per_layer": [dict(m, workloads=[CELL]) for m in bench["per_layer"]
                      if m["name"] in READERS]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "metrics").mkdir()
    (root / "BENCHMARK.json").write_text(json.dumps(benchmark(), indent=1))
    (root / "portbench" / "configs" / f"{NAME}.json").write_text(
        json.dumps(tiny_config(), indent=1))
    shutil.copy(ROOT / "portbench" / "configs" / "pixit-wavlm-large.py",
                root / "portbench" / "configs" / f"{NAME}.py")
    for reader in READERS:
        shutil.copy(ROOT / "portbench" / "metrics" / f"{reader}.py",
                    root / "portbench" / "metrics" / f"{reader}.py")
    return root


@pytest.fixture(scope="module")
def short_mix():
    from portbench.tests.conftest import TINY_MIX
    return dict(TINY_MIX, pool_files=3, median_minutes=0.12,
                min_minutes=0.08, max_minutes=0.2)


def module(tree):
    return harness.config_module(tree, NAME)


def _run(capsys, tree, mix, prepare=None, trace=0):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.01", "--trace", str(trace)],
                      device=torch.device("cpu"), prepare=prepare, mix=mix,
                      root=tree)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    return json.loads(out[-1])


def _state():
    out = {}
    for path in sorted((ROOT / "portbench").rglob("*")):
        parts = path.relative_to(ROOT).parts
        if path.is_file() and "__pycache__" not in parts \
                and ".cache" not in parts:
            out[str(path)] = path.stat().st_mtime_ns
    return out


CHECKS = {"score_gap", "source_gap", "ssl_gap", "emb_gap", "cluster_mismatch",
          "annotation_mismatch", "separated_gap", "failed"}


def test_a_tiny_cell_runs_and_is_correct(capsys, tree, short_mix):
    before = _state()
    line = _run(capsys, tree, short_mix)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == CHECKS
    assert set(line["metrics"]) == {"diar_audio_s_per_s", "setup_s"}
    assert line["attempted"] >= 2 and line["failed"] == 0
    traced = _run(capsys, tree, short_mix, trace=1)
    assert traced["correct"] is True, traced["checks"]
    # the device readers find no device time on the CPU
    assert set(traced["metrics"]) == {"sep_post_host_s_per_audio_h"}
    assert traced["metrics"]["sep_post_host_s_per_audio_h"]["value"] > 0
    assert _state() == before


def test_the_control_is_not_correct(tree, short_mix):
    found = control(CELL, SEED, "tf32-fp8", torch.device("cpu"),
                    mix=short_mix, root=tree)
    limits = tiny_config()["limits"]
    assert any(numbers[name] > limits[name] for _, _, numbers in found
               for name in numbers), found


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


def swapped_clusters(pipeline):
    """Each chunk's first two local speakers handed each other's
    clusters."""
    original = pipeline.clustering

    def clustering(*args, **kwargs):
        hard, soft, centroids = original(*args, **kwargs)
        hard = np.array(hard)
        hard[:, [0, 1]] = hard[:, [1, 0]]
        return hard, soft, centroids
    pipeline.clustering = clustering


@pytest.mark.parametrize("fault,numbers", [
    (zeroed_source, ("source_gap",)),
    (swapped_clusters, ("cluster_mismatch", "annotation_mismatch",
                        "separated_gap"))])
def test_a_broken_separation_is_not_correct(capsys, tree, short_mix, fault,
                                            numbers):
    line = _run(capsys, tree, short_mix, prepare=fault)
    assert line["correct"] is False
    assert any(line["checks"][n]["value"] > line["checks"][n]["limit"]
               for n in numbers), line["checks"]


def test_lstm_launches_are_those_of_a_run(tree, short_mix, monkeypatch,
                                          tmp_path):
    """Every (T, B) the program's recurrence is called with over one
    recording, against the module's list."""
    from pyannote_audio_tpu_torch.models.blocks import rnn
    from portbench.traffic.generator import Traffic
    mod = module(tree)
    config = tiny_config()
    seen = []
    original = rnn.LSTMRecurrence

    class Counted:
        @staticmethod
        def apply(xw, *args):
            seen.append(tuple(xw.shape[:2]))
            return original.apply(xw, *args)
    monkeypatch.setattr(rnn, "LSTMRecurrence", Counted)
    traffic = Traffic(short_mix, SEED, tmp_path)
    traffic.write("cpu")
    ctx = harness.Context(SEED, torch.device("cpu"), tmp_path, config,
                          traffic)
    pipeline, _ = mod.build(ctx)
    rec = max(traffic.pool, key=lambda r: r.samples)
    seen.clear()
    pipeline({"audio": str(rec.path), "uri": "one"})
    assert seen == mod.lstm_launches(config, rec.samples)
    assert len(seen) == 2 * -(-mod._grid(config, rec.samples)[2] // 8)


def test_recording_flops_are_what_the_plain_model_executes(tree):
    """``recording_flops``' ToTaToNet stages over a 7-s recording (26
    chunks of 2 s) against ``FlopCounterMode`` over the plain model on the
    same chunks, less what the count leaves out by design: the positional
    conv's dropped frame."""
    from torch.utils.flop_counter import FlopCounterMode
    mod = module(tree)
    config = tiny_config()
    spec = config["segmentation"]
    samples = 7 * 16000
    window, step, chunks, padded = mod._grid(config, samples)
    assert chunks == 26
    p = draw(totatonet.leaves(spec), generator(3, 1, "cpu"), "cpu")
    totatonet.finish(p)
    x = torch.randn(padded).unfold(0, window, step)[:, None].contiguous()
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        totatonet.forward(spec, p, x, Numerics("float32"))
    counted = counter.get_total_flops()
    stages = mod.recording_flops(config, samples)
    model = sum(stages[k] for k in ("encoder", "wavlm", "dprnn", "decoder",
                                    "head"))
    ssl = spec["ssl"]
    _, ssl_frames = flops.wavlm_chunk_flops(window, ssl)
    dropped = chunks * 2 * (ssl["hidden"] // ssl["pos_conv_groups"]) \
        * ssl["hidden"] * ssl["pos_conv_kernel"]
    assert counted == model + dropped
    assert ssl_frames > 0 and set(stages) >= {"fbank", "trunk",
                                              "pool_and_embed"}


@pytest.mark.parametrize("collar", [1, 2, 3, 160])
def test_the_references_leakage_mask_is_scipys(collar):
    from scipy.ndimage import binary_dilation
    rng = np.random.default_rng(collar)
    n = 4000
    segments = [(0.0, 0.01), (0.2, 0.2003)] + [
        tuple(sorted(rng.uniform(0, n / 16000, 2))) for _ in range(5)] + \
        [(0.24, 0.25)]
    active = np.zeros(n, dtype=bool)
    for a, b in segments:
        active[int(a * 16000):int(b * 16000)] = True
    expected = binary_dilation(active, structure=np.ones(2 * collar))
    assert np.array_equal(totatonet.leakage_mask(segments, n, 16000, collar),
                          expected)


def test_the_configuration_is_at_published_widths():
    config = json.loads((ROOT / "portbench" / "configs"
                         / "pixit-wavlm-large.json").read_text())
    seg = config["segmentation"]
    assert seg["ssl"]["layers"] == 24 and seg["ssl"]["hidden"] == 1024
    assert seg["hparams"]["dprnn"]["n_repeats"] == 6
    assert config["reduced"] == []
    assert config["source"].startswith("https://")


@pytest.mark.parametrize("arithmetic", ["stated", "float32"])
def test_scores_are_held_to_the_stated_arithmetic(tree, arithmetic):
    """The check holds the chunk scores to the plain model in the
    configuration's own arithmetic (bf16 recurrent operands) and the
    chunk sources to it in float32: scores and sources of the plain model
    in one arithmetic stand for the program's; each gap is nil against
    its own arithmetic and not against the other."""
    mod = module(tree)
    config = tiny_config()
    spec = config["segmentation"]
    p = draw(totatonet.leaves(spec), generator(5, 1, "cpu"), "cpu")
    totatonet.finish(p)
    window, step, _, padded = mod._grid(config, 5 * 16000)
    x = 0.3 * torch.randn(padded, generator=torch.Generator().manual_seed(5))
    chunks = x.unfold(0, window, step)[:, None].contiguous()
    num = totatonet.STATED if arithmetic == "stated" else Numerics("float32")
    with torch.inference_mode():
        # logits centred and spread, as the fit leaves them: the drawn
        # head is nearly flat
        pooled, _ = totatonet.forward(spec, p, chunks, Numerics("float32"),
                                      features=True)
        z = totatonet.head(pooled, p, spec["hparams"])
        gain = 2.0 / z.std()
        p["classifier.weight"] = p["classifier.weight"] * gain
        p["classifier.bias"] = (p["classifier.bias"] - z.median()) * gain
        scores, sources = totatonet.forward(spec, p, chunks, num)
    score_gap, source_gap, _, _, _ = mod._model_gaps(
        config, p, x, window, step, scores.numpy(), sources)
    if arithmetic == "stated":
        assert score_gap == 0.0 and source_gap > 1e-6
    else:
        assert score_gap > 1e-4 and source_gap == 0.0


def test_the_weights_repeat_from_the_seed(tree, short_mix, tmp_path):
    """Two draws from one seed, the fitted head and ``seg_1`` included,
    are the same weights."""
    from portbench.traffic.generator import Traffic
    mod = module(tree)
    traffic = Traffic(short_mix, SEED, tmp_path)
    ctx = harness.Context(SEED, torch.device("cpu"), tmp_path, tiny_config(),
                          traffic, log=lambda message: None)
    first, second = mod.draw_weights(ctx), mod.draw_weights(ctx)
    for part in ("segmentation", "embedding"):
        assert first[part].keys() == second[part].keys()
        for name, value in first[part].items():
            assert torch.equal(value, second[part][name]), (part, name)
