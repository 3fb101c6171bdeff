"""community1: the shape of pyannote/speaker-diarization-community-1.

PyanNet (SincNet at stride 10, BiLSTM 4 x 128, 2 x Linear 128, 7 powerset
classes) and WeSpeaker ResNet34 ((3, 4, 6, 3) x 32 channels, 80 mel bins,
256-d, bf16 trunk) with VBx over a PLDA 256 -> 128, all at published
widths and batches, with weights drawn and fitted from the seed. The
benchmark writes them as a snapshot into the run's work directory and
the program loads it through ``Pipeline.from_pretrained``, as a user
loads the published one.
"""

from __future__ import annotations

from portbench import calibration
from portbench.diarization import (  # noqa: F401  the harness's hooks
    check, control, install, lstm_launches, lstm_trace, recording_flops,
    warmup, well_formed)
from portbench.reference import pyannet, resnet
from portbench.snapshot import write_checkpoint, write_plda
from portbench.weights import draw, generator

def draw_weights(ctx) -> dict:
    """Every weight of the configuration, from the seed: drawn, then the
    segmentation head, ``seg_1`` and the PLDA fitted
    (``portbench/calibration.py``)."""
    config = ctx.config
    spec = config["segmentation"]
    body, width = pyannet.leaves(spec["hparams"], spec["weight_scale"])
    weights = {
        "segmentation": draw(body + pyannet.head_leaves(spec, width),
                             generator(ctx.seed, 1, ctx.device), ctx.device),
        "embedding": draw(resnet.leaves(config["embedding"]["hparams"]),
                          generator(ctx.seed, 2, ctx.device), ctx.device)}
    weights["plda"] = calibration.fit(ctx, weights, (
        config["plda"]["dim"], config["plda"]["lda_dim"]))
    return weights


def build(ctx):
    """-> (pipeline on ctx.device, the weights the reference gets)."""
    from pyannote_audio_tpu_torch import Pipeline
    config = ctx.config
    seg, emb = config["segmentation"], config["embedding"]
    weights = draw_weights(ctx)
    root = ctx.workdir / "snapshot"
    write_checkpoint(weights["segmentation"], seg["architecture"],
                     seg["hparams"], seg["specifications"],
                     root / "segmentation")
    write_checkpoint(weights["embedding"], emb["architecture"],
                     emb["hparams"], None, root / "embedding")
    write_plda(weights["plda"], root / "plda")
    snapshot = {
        "version": "4.0.0", "checkpoint": str(root),
        "pipeline": {
            "name": "pyannote.audio.pipelines.SpeakerDiarization",
            "params": {
                "clustering": config["clustering"]["class"],
                "embedding": "$model/embedding",
                "embedding_batch_size": config["embedding_batch_size"],
                "embedding_exclude_overlap":
                    config["embedding_exclude_overlap"],
                "plda": "$model/plda",
                "segmentation": "$model/segmentation",
                "segmentation_batch_size": config["segmentation_batch_size"]}},
        "params": config["instantiate"]}
    pipeline = Pipeline.from_pretrained(snapshot, device=ctx.device)
    return pipeline, weights
