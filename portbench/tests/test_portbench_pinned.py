"""Numbers of the two diarization configurations, pinned at what the
harness computed before its configuration hooks moved into the
configuration modules (``portbench/diarization.py``): the FLOPs by stage
and the LSTM launches of three recordings of ``lists4``'s pool, the
warm-up recordings, the reference's log-probs at a small size, and every
number the check compares on one CPU run of each configuration's cell
(the tiny mix). Integers must be equal, floats within 1e-6 relative."""

import json
from itertools import groupby

import pytest
import torch

from portbench import harness
from portbench.harness import ROOT
from portbench.reference import pyannet, segmentation_models, sseriouss
from portbench.reference.numerics import Numerics
from portbench.traffic.generator import Traffic, load_mix
from portbench.weights import draw, generator

CONFIGS = ("community1", "sseriouss-wavlm-base")

# the shortest, the middle and the longest recording of lists4's pool
PICKED = (1153536, 4978793, 14400000)

FLOPS = {
    "community1": [
        {"sinc": 4689684000, "segmentation": 127644993536,
         "fbank": 3301031360, "trunk": 326276751360,
         "pool_and_embed": 626196480},
        {"sinc": 20046868000, "segmentation": 604319266272,
         "fbank": 14111479360, "trunk": 1408449100800,
         "pool_and_embed": 2964648960},
        {"sinc": 57829396000, "segmentation": 1777057644384,
         "fbank": 40707895360, "trunk": 4073842268160,
         "pool_and_embed": 8717829120}],
    "sseriouss-wavlm-base": [
        {"segmentation": 9617056940032, "fbank": 3301031360,
         "trunk": 326276751360, "pool_and_embed": 626196480},
        {"segmentation": 45530753950464, "fbank": 14111479360,
         "trunk": 1408449100800, "pool_and_embed": 2964648960},
        {"segmentation": 133887464587008, "fbank": 40707895360,
         "trunk": 4073842268160, "pool_and_embed": 8717829120}],
}

# ((T, B), launches in a row) of each picked recording
LAUNCHES = {
    "community1": [[((589, 32), 8)],
                   [((589, 32), 36), ((589, 15), 4)],
                   [((589, 32), 108), ((589, 27), 4)]],
    "sseriouss-wavlm-base": [[((499, 32), 8)],
                             [((499, 32), 36), ((499, 15), 4)],
                             [((499, 32), 108), ((499, 27), 4)]],
}

# samples of the warm-up recordings, by configuration and mix
WARMUP = {("community1", "lists16"): [1640058, 14400000],
          ("community1", "lists1"): [1640058, 14400000],
          ("community1", "lists4"): [1640058, 14400000],
          ("sseriouss-wavlm-base", "lists4"): [1640058]}

# the reference's log-probs of two chunks of N(0, 0.1^2) noise (seed 1234)
# under weights drawn from seed 7, with no fit
LOGP = {
    "community1": {
        "shape": [2, 589, 7], "sum": -16049.269015073776,
        "abs": 16049.269015073776,
        "first": [-1.9224748611450195, -1.930238962173462,
                  -1.9791638851165771, -1.9414418935775757,
                  -1.9476615190505981, -1.994284749031067,
                  -1.908908486366272],
        "last": [-1.91966712474823, -1.9300494194030762,
                 -1.9779982566833496, -1.9421571493148804,
                 -1.9490903615951538, -1.9945472478866577,
                 -1.9106495380401611],
        "num_frames": 589, "frames": [0.0619375, 0.016875],
        "hparams": ["linear", "lstm", "num_channels", "sample_rate",
                    "sincnet"]},
    "sseriouss-wavlm-base": {
        "shape": [2, 499, 7], "sum": -13603.695236444473,
        "abs": 13603.695236444473,
        "first": [-1.9189698696136475, -1.998289704322815,
                  -1.9200100898742676, -1.9284700155258179,
                  -2.0123987197875977, -1.994361400604248,
                  -1.8583426475524902],
        "last": [-1.9138309955596924, -1.997736930847168,
                 -1.9226889610290527, -1.9272141456604004,
                 -2.012559175491333, -1.9982891082763672,
                 -1.8587689399719238],
        "num_frames": 499, "frames": [0.025, 0.02],
        "hparams": ["freeze_wav2vec", "linear", "lstm", "num_channels",
                    "sample_rate", "ssl", "wav2vec", "wav2vec_layer"]},
}

# one CPU run of each cell on the tiny mix, seed 2 ** 40 + 19
CHECKS = {
    "community1.batch": {
        "attempted": 4, "failed": 0,
        "checks": {"logp_mean_gap": 0.00033030458143912256,
                   "logp_chunk_gap": 0.0004428441752679646,
                   "emb_gap": 0.024683608261034013,
                   "emb_gap_e2e": 0.010463096695657146,
                   "decode_mismatch": 0, "count_mismatch": 0,
                   "cluster_mismatch": 0, "annotation_mismatch": 0,
                   "failed": 0}},
    "sseriouss.batch": {
        "attempted": 4, "failed": 0,
        "checks": {"logp_mean_gap": 4.24799964093836e-06,
                   "logp_chunk_gap": 4.608924882631982e-06,
                   "ssl_gap": 1.0887622465816094e-06,
                   "emb_gap": 0.01077303949139414,
                   "emb_gap_e2e": 0.008132754513935565,
                   "decode_mismatch": 0, "count_mismatch": 0,
                   "cluster_mismatch": 0, "annotation_mismatch": 0,
                   "failed": 0}},
}


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _module(name):
    return harness.config_module(ROOT, name)


def _same(value, pinned):
    if isinstance(pinned, int):
        assert value == pinned
    else:
        assert value == pytest.approx(pinned, rel=1e-6, abs=0.0)


def test_the_picked_recordings_are_of_lists4s_pool(tmp_path):
    pool = {r.samples for r in Traffic(load_mix("lists4"), 1, tmp_path).pool}
    assert set(PICKED) <= pool


@pytest.mark.parametrize("name", CONFIGS)
def test_recording_flops(name):
    module, config = _module(name), _config(name)
    for samples, pinned in zip(PICKED, FLOPS[name]):
        assert module.recording_flops(config, samples) == pinned


@pytest.mark.parametrize("name", CONFIGS)
def test_lstm_launches_and_trace(name):
    module, config = _module(name), _config(name)
    for samples, pinned in zip(PICKED, LAUNCHES[name]):
        launches = module.lstm_launches(config, samples)
        assert [(k, len(list(g))) for k, g in groupby(launches)] == pinned

    class Recording:
        def __init__(self, samples):
            self.samples = samples
    trace = module.lstm_trace(config, [Recording(n) for n in PICKED])
    assert trace == {"hidden": 128, "directions": 2, "precision": "default",
                     "launches": [shape for n in PICKED for shape in
                                  module.lstm_launches(config, n)]}


@pytest.mark.parametrize("name, mix", sorted(WARMUP))
def test_warmup_choice(tmp_path, name, mix):
    traffic = Traffic(load_mix(mix), 2 ** 40 + 5, tmp_path)
    chosen = _module(name).warmup(traffic, _config(name))
    assert [r.samples for r in chosen] == WARMUP[name, mix]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logprobs(name):
    spec = _config(name)["segmentation"]
    pinned = LOGP[name]
    if name == "community1":
        body, width = pyannet.leaves(spec["hparams"], spec["weight_scale"])
    else:
        body, width = sseriouss.leaves(segmentation_models.hparams(spec),
                                       spec["weight_scale"])
    p = draw(body + pyannet.head_leaves(spec, width), generator(7, 1, "cpu"),
             "cpu")
    if name != "community1":
        sseriouss.finish(p)
    chunks = torch.randn(2, 1, 160000,
                         generator=torch.Generator().manual_seed(1234)) * 0.1
    with torch.inference_mode():
        logp = segmentation_models.forward(spec, p, chunks,
                                           Numerics("float32")).double()
    assert list(logp.shape) == pinned["shape"]
    _same(float(logp.sum()), pinned["sum"])
    _same(float(logp.abs().sum()), pinned["abs"])
    for got, want in zip(logp[0, 0].tolist() + logp[1, -1].tolist(),
                         pinned["first"] + pinned["last"]):
        _same(got, want)
    assert segmentation_models.num_frames(spec, 160000) == \
        pinned["num_frames"]
    assert list(segmentation_models.frames(spec)) == pinned["frames"]
    assert sorted(segmentation_models.hparams(spec)) == pinned["hparams"]


@pytest.mark.parametrize("workload", sorted(CHECKS))
def test_the_checks_numbers(capsys, tiny_mix, accelerator_semantics,
                            workload):
    rc = harness.main(["--workload", workload, "--seed", str(2 ** 40 + 19),
                       "--seconds", "0.01", "--trace", "0"],
                      device=torch.device("cpu"), mix=tiny_mix)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    line = json.loads(out[-1])
    pinned = CHECKS[workload]
    assert line["correct"] is True
    assert (line["attempted"], line["failed"]) == \
        (pinned["attempted"], pinned["failed"])
    assert list(line["checks"]) == list(pinned["checks"])
    for name, value in pinned["checks"].items():
        _same(line["checks"][name]["value"], value)
