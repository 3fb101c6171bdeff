"""The check against faults of the timed path: a run of ``community1.batch``
on the CPU (the harness's look for a card skipped, the accelerator path's
semantics switched on, the tiny mix) with the program broken underneath
must print ``correct`` false, and the unbroken run true."""

import json

import pytest
import torch

from portbench import harness

SEED = 2 ** 40 + 19


def _tamper_segmentation(pipeline, change):
    """``change(out)`` applied to every segmentation batch where the model
    produces it."""
    model = pipeline._segmentation.model
    original = model.forward_from_frontend

    def forward(*args, **kwargs):
        return change(original(*args, **kwargs))
    model.forward_from_frontend = forward


def swapped_logprobs(pipeline):
    """Each batch's first and last chunks get each other's answers."""
    def change(out):
        return torch.cat([out[-1:], out[1:-1], out[:1]]) if len(out) > 1 \
            else out + 1.0
    _tamper_segmentation(pipeline, change)


def half_the_batch(pipeline):
    """Only the first half of each batch computed, its outputs standing in
    for the second half's."""
    def change(out):
        half = (len(out) + 1) // 2
        return torch.cat([out[:half], out[:len(out) - half]])
    _tamper_segmentation(pipeline, change)


def altered_embedding(pipeline):
    model = pipeline._embedding
    original = model.embed

    def embed(*args, **kwargs):
        out = original(*args, **kwargs).clone()
        out[0] += out[0].norm() * 0.5 / out[0].numel() ** 0.5
        return out
    model.embed = embed


def altered_clusters(pipeline):
    original = pipeline.clustering

    def clustering(*args, **kwargs):
        hard, soft, centroids = original(*args, **kwargs)
        hard = hard.copy()
        hard[0] = hard[0][::-1] + 1
        return hard, soft, centroids
    pipeline.clustering = clustering


def broken_plda(pipeline):
    """VBx in a PLDA space whose between-class variances are reversed."""
    plda = pipeline.clustering.plda

    class Reversed:
        phi = plda.phi[::-1].copy()

        def __call__(self, x):
            return plda(x)
    pipeline.clustering.plda = Reversed()


def altered_annotation(pipeline):
    original = pipeline.to_annotation

    def to_annotation(*args, **kwargs):
        annotation = original(*args, **kwargs)
        tracks = list(annotation.itertracks(yield_label=True))
        if tracks:
            segment, track, _ = tracks[-1]
            del annotation[segment, track]
        return annotation
    pipeline.to_annotation = to_annotation


def _run(capsys, prepare=None, trace=0):
    rc = harness.main(["--workload", "community1.batch", "--seed",
                       str(SEED), "--seconds", "0.01", "--trace",
                       str(trace)], device=torch.device("cpu"),
                      prepare=prepare, mix=_run.mix)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    return json.loads(out[-1])


@pytest.fixture
def run(capsys, tiny_mix, accelerator_semantics):
    _run.mix = tiny_mix
    return lambda prepare=None, trace=0: _run(capsys, prepare, trace)


def test_the_sound_run_is_correct(run):
    line = run()
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"diar_audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("fault, caught_by", [
    (swapped_logprobs, "logp_chunk_gap"),
    (half_the_batch, "logp_chunk_gap"),
    (altered_embedding, "emb_gap"),
    (altered_clusters, "cluster_mismatch"),
    (broken_plda, "cluster_mismatch"),
    (altered_annotation, "annotation_mismatch"),
])
def test_a_broken_path_is_not_correct(run, fault, caught_by):
    line = run(fault)
    assert line["correct"] is False
    check = line["checks"][caught_by]
    assert check["value"] > check["limit"]
