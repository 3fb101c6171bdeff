"""sseriouss-wavlm-base: SSeRiouSS over WavLM-base, at the port's defaults.

The WavLM-base trunk (12 layers x 768, 12 heads, feed-forward 3072,
float32 with TF32 off), the softmax-weighted average of its layers, a
BiLSTM of 4 x 128, 2 x Linear 128 and 7 powerset classes, with the
WeSpeaker ResNet34 of ``community1`` and the centroid AHC of
speaker-diarization-3.1, all at published widths, with weights drawn and
fitted from the seed. The program's model classes are
built at the configuration's sizes and loaded with those weights (no
checkpoint is written: the trunk alone is 380 MB), then handed to its
``SpeakerDiarization``.
"""

from __future__ import annotations

import torch

from portbench import calibration
from portbench.diarization import (  # noqa: F401  the harness's hooks
    check, control, install, lstm_launches, lstm_trace, recording_flops,
    warmup, well_formed)
from portbench.reference import pyannet, resnet, sseriouss
from portbench.weights import draw, generator

def draw_weights(ctx) -> dict:
    """Every weight of the configuration, from the seed: drawn, then the
    segmentation head and ``seg_1`` fitted
    (``portbench/calibration.py``)."""
    config = ctx.config
    spec = config["segmentation"]
    body, width = sseriouss.leaves(dict(spec["hparams"], ssl=spec["ssl"]),
                                   spec["weight_scale"])
    segmentation = draw(body + pyannet.head_leaves(spec, width),
                        generator(ctx.seed, 1, ctx.device), ctx.device)
    sseriouss.finish(segmentation)
    weights = {
        "segmentation": segmentation,
        "embedding": draw(resnet.leaves(config["embedding"]["hparams"]),
                          generator(ctx.seed, 2, ctx.device), ctx.device)}
    calibration.fit(ctx, weights)
    return weights


def build(ctx):
    """-> (pipeline on ctx.device, the weights the reference gets). The
    models are the program's classes at the configuration's sizes,
    loaded with the benchmark's weights in the reference layout."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.sseriouss import \
        SSeRiouSS
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    config = ctx.config
    seg, emb = config["segmentation"]["hparams"], config["embedding"]
    weights = draw_weights(ctx)
    segmentation = SSeRiouSS(wav2vec=seg["wav2vec"],
                             wav2vec_layer=seg["wav2vec_layer"],
                             lstm=seg["lstm"], linear=seg["linear"],
                             sample_rate=seg["sample_rate"])
    segmentation.load_reference_state_dict(
        {k: v.cpu() for k, v in weights["segmentation"].items()})
    embedding = WeSpeakerResNet34(
        compute_dtype=getattr(torch, emb["hparams"]["compute_dtype"]))
    embedding.load_reference_state_dict(
        dict({k: v.cpu() for k, v in weights["embedding"].items()},
             **batch_norm_counts(weights["embedding"])))
    pipeline = SpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering=config["clustering"]["class"],
        embedding_exclude_overlap=config["embedding_exclude_overlap"],
        segmentation_step=config["segmentation_step"],
        segmentation_batch_size=config["segmentation_batch_size"],
        embedding_batch_size=config["embedding_batch_size"],
        device=ctx.device)
    return pipeline.instantiate(config["instantiate"]), weights


def batch_norm_counts(state: dict) -> dict:
    """``num_batches_tracked`` beside each BatchNorm's statistics."""
    return {k.replace("running_var", "num_batches_tracked"):
            torch.tensor(0, dtype=torch.int64)
            for k in state if k.endswith("running_var")}
