"""pixit-wavlm-large: PixIT's ToTaToNet with WavLM-large, as
pyannote/speech-separation-ami-1.0 serves it, through the port's
``SpeechSeparation``.

ToTaToNet (a free conv encoder of 64 filters, the WavLM-large branch at
24 of its 24 layers, a DPRNN masker of 6 x 128, 3 sources decoded by a
transposed conv, a pooled diarization head of leaky-ReLU linears) on 5-s
chunks every 0.5 s in batches of 32, then the pipeline: binarize, count,
the WeSpeaker ResNet34 (bf16 trunk) embeddings of the local speakers,
centroid AHC, reconstruction, the overlap-add of each chunk's sources per
speaker on the card, leakage removal and peak normalisation. Every
weight is drawn from the seed and the heads fitted in set-up; the
program's classes are built at the configuration's sizes and loaded with
those weights (no checkpoint is written: WavLM-large alone is 1.26 GB).

What the harness asks of this module (``harness.py``) and where each
check's reference lives (``portbench/reference/totatonet.py``, its
WavLM-large, DPRNN and pipeline tail; ``resnet.py``; ``clustering.py``).
The program's ``SpeechSeparation`` needs its leakage mask linear in the
samples (``speech_separation.dilate``): a program without it takes minutes
of host time per recording there, and ``build`` refuses to run it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import calibration, flops
from portbench.reference import clustering, reconstruct, resnet, totatonet
from portbench.reference.numerics import Numerics
from portbench.traffic import generator as gen
from portbench.weights import draw, generator

# the pool indices of the recordings the check reads, drawn from the
# run's seed in ``build``: the longest and seeded others
CHECKED: List[int] = []
HEAD_BATCH, HEAD_RATE = 4096, 3e-3
ADAM = (0.9, 0.999, 1e-8)        # beta1, beta2, eps
# a fitted head that tells the bands apart no better than this (balanced
# accuracy) is centred and scaled instead, as chip_smoke's
# calibrate_sigmoid does, so that its scores are no near tie
FOLLOWS, LOGIT_SPREAD = 0.6, 1.5


# -- the grid ------------------------------------------------------------------

def _grid(config: dict, num_samples: int) -> Tuple[int, int, int, int]:
    """(window, step, chunks, grid-padded samples) of a recording."""
    spec = config["segmentation"]
    window = int(round(spec["specifications"]["duration"]
                       * spec["hparams"]["sample_rate"]))
    step = int(round(config["segmentation_step"] * window))
    chunks, padded = flops.chunk_grid(num_samples, window, step)
    return window, step, chunks, padded


def _dprnn_shape(config: dict) -> Tuple[int, int, int]:
    """(encoder frames, DPRNN chunks, frames a DPRNN chunk) of one
    chunk."""
    hp = config["segmentation"]["hparams"]
    ed, K = hp["encoder_decoder"], hp["dprnn"]["chunk_size"]
    window, _, _, _ = _grid(config, 0)
    frames = flops.conv1d_out(window, ed["kernel_size"], ed["stride"])
    return frames, (frames + K) // (K // 2) + 1, K


def _batches(config: dict, chunks: int) -> List[int]:
    batch = config["segmentation_batch_size"]
    return [batch] * (chunks // batch) + ([chunks % batch]
                                          if chunks % batch else [])


# -- the weights ---------------------------------------------------------------

def draw_weights(ctx) -> dict:
    """Every weight of the configuration, from the seed: drawn, then the
    diarization head and ``seg_1`` fitted (``fit``)."""
    config = ctx.config
    spec = config["segmentation"]
    segmentation = draw(totatonet.leaves(spec),
                        generator(ctx.seed, 1, ctx.device), ctx.device)
    totatonet.finish(segmentation)
    weights = {
        "segmentation": segmentation,
        "embedding": draw(resnet.leaves(config["embedding"]["hparams"]),
                          generator(ctx.seed, 2, ctx.device), ctx.device)}
    fit(ctx, weights)
    return weights


def fit_head(p: Dict[str, torch.Tensor], hp: dict, features: torch.Tensor,
             targets: torch.Tensor, seed: int, steps: int) -> None:
    """The linear layers and the classifier in ``p``, fitted by Adam to
    the 0/1 ``targets`` from ``features`` (rows, filters) by binary cross
    entropy, minibatches drawn from the seed (``calibration.fit_head``'s
    loop, for a sigmoid)."""
    names = [f"{n}.{kind}" for n in
             [f"linear.{i}" for i in range(hp["linear"]["num_layers"])]
             + ["classifier"] for kind in ("weight", "bias")]
    state = {n: p[n].detach().clone().requires_grad_(True) for n in names}
    params = list(state.values())
    moments = [(torch.zeros_like(q), torch.zeros_like(q)) for q in params]
    g = generator(seed, 5, features.device)
    for step in range(1, steps + 1):
        i = torch.randint(0, len(features), (HEAD_BATCH,), generator=g,
                          device=features.device)
        with torch.enable_grad():
            loss = F.binary_cross_entropy_with_logits(
                totatonet.head(features[i], state, hp), targets[i])
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for q, grad, (m, v) in zip(params, grads, moments):
                m.lerp_(grad, 1 - ADAM[0])
                v.lerp_(grad * grad, 1 - ADAM[1])
                q.addcdiv_(m, (v / (1 - ADAM[1] ** step)).sqrt_().add_(
                    ADAM[2]), value=-HEAD_RATE / (1 - ADAM[0] ** step))
    for name, value in state.items():
        p[name] = value.detach().clone()


def fit(ctx, weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Fit the drawn ``weights`` in place on labelled recordings of the
    cell's mix (``calibration.labelled``): the diarization head so that
    source k follows the voice in pitch band k (centred and scaled
    instead where the fit tells the bands apart no better than
    ``FOLLOWS``), then ``seg_1`` a discriminant of the voices under the
    fitted model's masks (``calibration.embedding``)."""
    config = ctx.config
    spec, mix = config["segmentation"], ctx.traffic.mix
    hp, plan = spec["hparams"], mix["calibration"]
    p = weights["segmentation"]
    start = time.perf_counter()
    # synthesised on the host: the card's index_add_ sums overlapping
    # voices in no fixed order, and the fit turns the PCM rounding that
    # moves into another head from run to run of one seed
    recordings = [(audio.to(ctx.device), rows) for audio, rows in
                  calibration.labelled(mix, ctx.seed, torch.device("cpu"))]
    chunks, starts = calibration.chunked(recordings, spec,
                                         plan["hop_seconds"])
    window, _, _, _ = _grid(config, 0)
    S = hp["n_sources"]
    bands = np.concatenate([
        calibration.activity(rows, calibration.centres(spec, s, window),
                             rows[:, gen.BAND], len(mix["f0_bands"]))
        for (_, rows), s in zip(recordings, starts)])[..., :S]
    with torch.inference_mode():
        pooled, _ = totatonet.forward(spec, p, chunks, Numerics("float32"),
                                      features=True)    # (N, S, F, filters)
    features = pooled.flatten(0, 2).clone()
    targets = torch.as_tensor(bands.transpose(0, 2, 1), dtype=torch.float32,
                              device=features.device).flatten()
    fit_head(p, hp, features, targets, ctx.seed, plan["head_steps"])
    with torch.no_grad():
        logits = totatonet.head(features, p, hp)
        on = logits > 0
        truth = targets > 0.5
        balanced = 0.5 * (float(on[truth].float().mean())
                          + float((~on[~truth]).float().mean()))
        centred = balanced < FOLLOWS
        if centred:
            gain = LOGIT_SPREAD / logits.double().std()
            p["classifier.weight"] = p["classifier.weight"] * gain.float()
            p["classifier.bias"] = (p["classifier.bias"]
                                    - logits.median()) * gain.float()
            logits = totatonet.head(features, p, hp)
        threshold = config["instantiate"]["segmentation"]["threshold"]
        decoded = (torch.sigmoid(logits) > threshold).reshape(
            pooled.shape[:3]).transpose(1, 2).cpu().numpy()   # (N, F, S)
    ctx.log(f"diarization head fitted in {time.perf_counter() - start:.3f}"
            f" s: balanced accuracy {balanced:.4f}, active share "
            f"{float(truth.float().mean()):.4f} (truth) / "
            f"{float(decoded.mean()):.4f} (decoded)"
            + ("; centred and scaled" if centred else ""))
    start = time.perf_counter()
    masks = calibration.speaker_masks(spec, recordings, starts,
                                      decoded.astype(np.float64))
    calibration.embedding(weights["embedding"],
                          config["embedding"]["hparams"], spec, masks,
                          recordings)
    ctx.log(f"seg_1 fitted in {time.perf_counter() - start:.3f} s")


def checked_pool(traffic, seed: int, files: int) -> List[int]:
    """Pool indices the check reads: the longest and ``files - 1`` others
    drawn from the seed."""
    pool = sorted(traffic.pool, key=lambda r: (-r.samples, r.index))
    others = gen.seeded(seed, 3).choice(len(pool) - 1, size=min(
        files, len(pool)) - 1, replace=False)
    return [pool[0].index] + [pool[1 + int(i)].index for i in others]


def build(ctx):
    """-> (pipeline on ctx.device, the weights the reference gets)."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.separation.totatonet import (
        ToTaToNet, default_specifications)
    from pyannote_audio_tpu_torch.pipelines import speech_separation
    if not hasattr(speech_separation, "dilate"):
        raise RuntimeError(
            "pixit-wavlm-large needs SpeechSeparation's leakage mask linear "
            "in the samples (speech_separation.dilate); this program dilates "
            "in O(samples x collar), minutes of host time a recording: "
            "no result")
    config = ctx.config
    spec, emb = config["segmentation"], config["embedding"]["hparams"]
    hp = spec["hparams"]
    weights = draw_weights(ctx)
    CHECKED[:] = checked_pool(ctx.traffic, ctx.seed, config["check_files"])
    ssl = spec["ssl"]
    model = ToTaToNet(
        encoder_decoder=hp["encoder_decoder"], linear=hp["linear"],
        diar=hp["diar"], dprnn=hp["dprnn"], n_sources=hp["n_sources"],
        sample_rate=hp["sample_rate"], use_wavlm=True,
        wavlm_config={k: ssl[k] for k in (
            "hidden", "layers", "heads", "ffn", "conv_channels",
            "rel_pos_bias", "pre_ln", "conv_norm")},
        specifications=default_specifications(
            hp["n_sources"], spec["specifications"]["duration"]))
    model.load_reference_state_dict(
        {k: v.cpu() for k, v in weights["segmentation"].items()})
    embedding = WeSpeakerResNet34(
        num_blocks=emb["num_blocks"], m_channels=emb["m_channels"],
        num_mel_bins=emb["num_mel_bins"], embed_dim=emb["embed_dim"],
        compute_dtype=getattr(torch, emb["compute_dtype"]))
    embedding.load_reference_state_dict(dict(
        {k: v.cpu() for k, v in weights["embedding"].items()},
        **{k.replace("running_var", "num_batches_tracked"):
           torch.tensor(0, dtype=torch.int64)
           for k in weights["embedding"] if k.endswith("running_var")}))
    pipeline = speech_separation.SpeechSeparation(
        segmentation=model, embedding=embedding,
        clustering=config["clustering"]["class"],
        segmentation_step=config["segmentation_step"],
        segmentation_batch_size=config["segmentation_batch_size"],
        embedding_batch_size=config["embedding_batch_size"],
        device=ctx.device)
    return pipeline.instantiate(config["instantiate"]), weights


# -- the capture points --------------------------------------------------------

def _pool_index(uri: str):
    """The pool index a timed file's uri ends with (``_pNN``), else
    None."""
    head, _, tail = uri.rpartition("_p")
    return int(tail) if head and tail.isdigit() else None


def install(capture, pipeline) -> None:
    """Wrappers on one ``SpeechSeparation`` instance:

    - ``_separate``: host seconds under ``separate`` (the model over every
      chunk, up to the scores' copy); the chunk scores (host) and, for the
      first pass of a recording the check reads (``CHECKED``), the chunk
      sources (on the device, no copy) and the chunk starts;
    - ``apply``: the host seconds after ``_separate`` returns, to the
      end of ``apply`` (embedding, clustering, reconstruction, the
      overlap-add and its copy, leakage removal, normalisation), under
      ``post``;
    - ``clustering``: its inputs (embeddings, clean frames, the binarized
      chunk scores) and its hard clusters, copied on the host;
    - the model's WavLM (``portbench.wavlm``) and DPRNN masker
      (``portbench.dprnn``), and ``get_embeddings``
      (``portbench.embedding``): ranges with ``ranges``; WavLM's last
      state of the first batch of a checked recording, on the device.
    """
    model = pipeline._segmentation.model
    kept = set()
    ended = {}

    def checked(uri):
        index = _pool_index(uri)
        return index is not None and index in CHECKED and index not in kept

    def separate(original):
        def run(waveform, sample_rate, file):
            uri = file["uri"]
            capture.current = uri
            out = original(waveform, sample_rate, file)
            record = capture.files[uri]
            record["scores"] = out[0]
            if checked(uri):
                kept.add(_pool_index(uri))
                record["sources"], record["starts"] = out[1], out[2]
            ended[uri] = time.perf_counter()
            return out
        return capture.timed("separate", run)

    def apply(original):
        def run(file, *args, **kwargs):
            out = original(file, *args, **kwargs)
            end = time.perf_counter()
            start = ended.pop(file["uri"], None)
            if start is not None:
                capture.spans["post"] += end - start
                capture.intervals.append((start, end, "post"))
            return out
        return run

    def clustering_(original):
        def run(embeddings, clean_frames, **kwargs):
            out = original(embeddings, clean_frames, **kwargs)
            record = capture.files[capture.current]
            record["embeddings"] = np.array(embeddings)
            record["clean_frames"] = np.array(clean_frames)
            record["binarized"] = np.array(kwargs["segmentations"].data)
            record["hard"] = np.array(out[0])
            return out
        return capture.timed("clustering", run)

    def ssl(original):
        def run(*args, **kwargs):
            states = original(*args, **kwargs)
            record = capture.files[capture.current]
            if "sources" not in record and "ssl" not in record and \
                    checked(capture.current):
                record["ssl"] = states[-1]
            return states
        return capture.timed("wavlm", run)

    capture.wrap(pipeline, "_separate", separate)
    capture.wrap(pipeline, "apply", apply)
    capture.wrap(pipeline, "clustering", clustering_)
    capture.wrap(model.wavlm, "forward", ssl)
    capture.time(model.masker, "forward", "dprnn")
    capture.time(pipeline, "get_embeddings", "embedding")


# -- the warm-up and the counts ---------------------------------------------

def warmup(traffic, config: dict) -> list:
    """The shortest recording of the pool that fills one batch of chunks
    and leaves a tail batch, then the longest (the card's memory cache
    then holds blocks of every size a list asks for)."""
    batch = config["segmentation_batch_size"]
    first = max(traffic.pool, key=lambda r: r.samples)
    for rec in sorted(traffic.pool, key=lambda r: r.samples):
        _, _, chunks, _ = _grid(config, rec.samples)
        if chunks > batch and chunks % batch:
            first = rec
            break
    longest = max(traffic.pool, key=lambda r: r.samples)
    return [first] if first is longest else [first, longest]


def lstm_launches(config: dict, num_samples: int) -> List[Tuple[int, int]]:
    """(T, B) of each recurrence launch of one recording: per batch of b
    chunks and repeat, the intra-chunk BiLSTM (chunk frames, b x DPRNN
    chunks), then the inter-chunk one (DPRNN chunks, b x chunk frames)."""
    _, _, chunks, _ = _grid(config, num_samples)
    _, n, K = _dprnn_shape(config)
    repeats = config["segmentation"]["hparams"]["dprnn"]["n_repeats"]
    return [shape for b in _batches(config, chunks) for _ in range(repeats)
            for shape in ((K, b * n), (n, b * K))]


def chunk_flops(config: dict) -> Dict[str, int]:
    """FLOPs by stage of one chunk through ToTaToNet (1 MAC = 2 FLOPs;
    norms, gates' elementwise work and pooling left out): the encoder,
    WavLM-large (``flops.wavlm_chunk_flops``, and its per-layer gate
    linears), the DPRNN (bottleneck, BiLSTMs, their linears, the output
    convs), the decoder and the diarization head."""
    spec = config["segmentation"]
    hp, ssl = spec["hparams"], spec["ssl"]
    ed, d, S = hp["encoder_decoder"], hp["dprnn"], hp["n_sources"]
    F_, C, H = ed["n_filters"], d["bn_chan"], d["hid_size"]
    window, _, _, _ = _grid(config, 0)
    frames, n, K = _dprnn_shape(config)
    wavlm, ssl_frames = flops.wavlm_chunk_flops(window, ssl)
    gates = ssl["layers"] * 2 * ssl_frames * ssl["hidden"] * 8
    per_repeat = n * flops.lstm_flops(K, [C], H) \
        + K * flops.lstm_flops(n, [C], H) + 2 * (2 * n * K * 2 * H * C)
    dprnn = 2 * frames * (F_ + ssl["hidden"]) * C \
        + d["n_repeats"] * per_repeat + 2 * n * K * C * S * C \
        + 2 * 2 * frames * S * C * C + 2 * frames * S * C * F_
    widths = [F_] + [hp["linear"]["hidden_size"]] * \
        hp["linear"]["num_layers"] + [1]
    pooled = frames // totatonet.scaling(hp)
    return {"encoder": flops.conv1d_flops(frames, ed["kernel_size"], 1, F_),
            "wavlm": wavlm + gates, "dprnn": dprnn,
            "decoder": S * flops.conv1d_flops(frames, ed["kernel_size"], F_,
                                              1),
            "head": 2 * S * pooled * sum(a * b for a, b in
                                         zip(widths, widths[1:]))}


def recording_flops(config: dict, num_samples: int) -> Dict[str, int]:
    """Per-stage FLOPs of one recording: ToTaToNet over its real chunks
    (``chunk_flops``), and the embedding as the diarization
    configurations count it: the fbank over the chunk grid, the ResNet
    trunk over the recording's own frames once, the pooling and
    projection of each (chunk, local source)."""
    window, _, chunks, padded = _grid(config, num_samples)
    out = {stage: chunks * value
           for stage, value in chunk_flops(config).items()}
    emb = config["embedding"]["hparams"]
    out["fbank"] = flops.fbank_flops(flops.conv1d_out(padded, 400, 160))
    out["trunk"] = flops.resnet_trunk_flops_per_frame(
        emb["m_channels"], emb["num_blocks"], emb["num_mel_bins"]) * \
        flops.conv1d_out(num_samples, 400, 160)
    freq = emb["num_mel_bins"]
    trunk_frames = flops.conv1d_out(window, 400, 160)
    for _ in range(3):
        freq = (freq + 1) // 2
        trunk_frames = (trunk_frames - 1) // 2 + 1
    pooled = emb["m_channels"] * 8 * freq
    sources = config["segmentation"]["hparams"]["n_sources"]
    out["pool_and_embed"] = chunks * sources * (
        2 * trunk_frames * pooled + 2 * 2 * pooled * emb["embed_dim"])
    return out


def lstm_trace(config: dict, recordings) -> dict:
    """The trace's ``lstm`` entry for the recordings of a traced list."""
    return {"hidden": config["segmentation"]["hparams"]["dprnn"]["hid_size"],
            "directions": 2, "precision": config["lstm_precision"],
            "launches": [shape for r in recordings
                         for shape in lstm_launches(config, r.samples)]}


# -- the check -----------------------------------------------------------------

def well_formed(output) -> bool:
    annotation = getattr(output, "speaker_diarization", None)
    sources = getattr(output, "sources", None)
    return hasattr(annotation, "itertracks") and sources is not None and \
        getattr(sources, "ndim", 0) == 2


def _padded(audio: np.ndarray, padded: int, device) -> torch.Tensor:
    x = torch.zeros(padded, device=device)
    x[:len(audio)] = torch.as_tensor(audio, device=device)
    return x


def _model_gaps(config, p, x, window, step, scores, sources,
                ours: Numerics = None):
    """(score_gap, source_gap, ours' scores, ours' sources, the
    reference's sources): the program's chunk ``scores`` (C, F, S) and
    ``sources`` (C, window, S), or where they are None the plain model in
    the mode ``ours``, against the plain model batch by batch; the last
    three are kept only for ``ours``.

    The sources are held to the plain model in float32. The scores are
    held to it in the configuration's own arithmetic
    (``totatonet.STATED``: the recurrent product on bf16 operands, the
    rest float32, on the same WavLM state): the fitted head turns the
    bf16 recurrence's own rounding, a relative 0.2-1 % in the sources,
    into score gaps against float32 of 0.02-0.25 from one fit of the head
    to the next, which says nothing of the program; against the
    configuration's arithmetic the program's scores differ by its
    float32 summation order and the bf16 roundings that order flips."""
    spec = config["segmentation"]
    hp, ssl = spec["hparams"], spec["ssl"]
    grid = x.unfold(0, window, step)
    C = len(scores) if scores is not None else len(grid)
    score_gap = source_gap = 0.0
    kept = ([], [], [])
    for b in range(0, C, totatonet.BATCH):
        chunks = grid[b:b + totatonet.BATCH, None].contiguous()
        with torch.inference_mode():
            state = totatonet.ssl_output(spec, p, chunks[:, 0],
                                         Numerics("float32"))
            _, s = totatonet.totatonet(chunks, p, hp, ssl,
                                       Numerics("float32"), state=state)
            d, _ = totatonet.totatonet(chunks, p, hp, ssl, totatonet.STATED,
                                       state=state)
            del state
            if scores is None:
                ours_d, ours_s = totatonet.totatonet(chunks, p, hp, ssl,
                                                     ours)
                for part, value in zip(kept, (ours_d, ours_s, s)):
                    part.append(value)
            else:
                ours_d = torch.as_tensor(scores[b:b + totatonet.BATCH],
                                         device=d.device)
                ours_s = sources[b:b + totatonet.BATCH].to(d.device,
                                                           torch.float32)
        score_gap = max(score_gap, float((ours_d - d).abs().max()))
        source_gap = max(source_gap, float(totatonet.unit_gap(
            ours_s.flatten(1), s.flatten(1)).max()))
    return (score_gap, source_gap) + tuple(
        torch.cat(part) if part else None for part in kept)


def _embeddings(config, weights, x, starts, window, binarized, num_samples,
                num):
    hp = dict(config["embedding"]["hparams"], real_samples=num_samples)
    masks = torch.as_tensor(binarized, dtype=torch.float32,
                            device=x.device).transpose(1, 2)
    with torch.inference_mode():
        return resnet.embeddings(x, starts, window, masks,
                                 weights["embedding"], hp, num)


def _emb_gap(ours: np.ndarray, theirs: torch.Tensor,
             binarized: np.ndarray) -> float:
    theirs = theirs.double().cpu().numpy()
    active = binarized.sum(axis=1) > 0
    gap = np.linalg.norm(np.asarray(ours, np.float64) - theirs, axis=-1) / \
        np.maximum(np.linalg.norm(theirs, axis=-1), 1e-12)
    return float(gap[active].max()) if active.any() else 0.0


def _reconstruction(config, scores: np.ndarray, binarized: np.ndarray,
                    hard: np.ndarray):
    """The reference's count-constrained reconstruction from chunk scores
    and hard clusters (inactive local speakers -2): (normal, exclusive,
    frames decided beyond a tie, hard)."""
    spec = config["segmentation"]
    duration = spec["specifications"]["duration"]
    frame_duration, frame_step = totatonet.frames(spec)
    offsets, frames = totatonet.output_grid(
        len(scores), config["segmentation_step"] * duration, duration,
        frame_duration, frame_step)
    count = reconstruct.speaker_count(binarized, offsets, frames)
    hard = np.array(hard, dtype=np.int64)
    hard[binarized.sum(axis=1) == 0] = -2
    normal, exclusive, decided = totatonet.diarization(
        np.asarray(scores, np.float64), hard, count, offsets, frames)
    return normal, exclusive, decided, hard


def _segments(annotation) -> List[Tuple[float, float, str]]:
    return [(segment.start, segment.end, str(label)) for segment, _, label
            in annotation.itertracks(yield_label=True)]


def numbers(ctx, weights, audio: np.ndarray, record: dict, output
            ) -> Dict[str, float]:
    """Every compared number for one recording the program finished."""
    config = ctx.config
    spec = config["segmentation"]
    window, step, _, padded = _grid(config, len(audio))
    x = _padded(audio, padded, ctx.device)
    p = weights["segmentation"]
    out = {}
    out["score_gap"], out["source_gap"], _, _, _ = _model_gaps(
        config, p, x, window, step, record["scores"], record["sources"])
    ours = record["ssl"]
    theirs = totatonet.ssl_output(spec, p, x.unfold(0, window, step)[
        :len(ours)], Numerics("float32"))
    out["ssl_gap"] = float(totatonet.unit_gap(
        ours.to(theirs.device, torch.float32), theirs).max())
    binarized = record["binarized"]
    starts = np.asarray(record["starts"], dtype=np.int64)
    out["emb_gap"] = _emb_gap(record["embeddings"], _embeddings(
        config, weights, x, starts, window, binarized, len(audio),
        Numerics("float32")), binarized)
    ahc = clustering.method(config["clustering"]["kind"],
                            config["instantiate"]["clustering"], weights)
    speaker_frames = binarized.sum(axis=1)
    theirs_hard, soft = ahc(np.asarray(record["embeddings"], np.float64),
                            record["clean_frames"], speaker_frames,
                            binarized.shape[1])
    out["cluster_mismatch"] = clustering.moved(
        record["hard"], theirs_hard, soft, speaker_frames > 0,
        per_chunk=ahc.per_chunk)
    normal, exclusive, decided, hard = _reconstruction(
        config, record["scores"], binarized, record["hard"])
    frame_duration, frame_step = totatonet.frames(spec)
    undecided = set(np.flatnonzero(~decided).tolist())
    mismatch = 0
    for annotation, binary in ((output.speaker_diarization, normal),
                               (output.exclusive_speaker_diarization,
                                exclusive)):
        mismatch += totatonet.frames_apart(
            _segments(annotation),
            totatonet.labelled_runs(binary, normal, frame_duration,
                                    frame_step),
            undecided, 0.5 * frame_duration, frame_step)
    out["annotation_mismatch"] = mismatch
    labelled = {}
    for start, end, label in _segments(output.speaker_diarization):
        labelled.setdefault(label, []).append((start, end))
    clusters = totatonet.present(normal)
    theirs = totatonet.tail(record["sources"], hard, starts, len(audio),
                            labelled, clusters,
                            spec["hparams"]["sample_rate"],
                            config["instantiate"]["separation"]["asr_collar"])
    ours = np.asarray(output.sources, dtype=np.float64)
    out["separated_gap"] = float("inf") if ours.shape != theirs.shape \
        else max([totatonet.relative_l2(ours[:, i], theirs[:, i])
                  for i in range(ours.shape[1])], default=0.0)
    return out


def check(ctx, weights, done, outputs, records) -> Dict[str, float]:
    """Every compared number, the largest over the recordings the check
    reads (``CHECKED``: the longest of the pool and a seeded other), each
    at its first finished pass."""
    first = {}
    for d in done:
        for f, r in zip(d["files"], d["recordings"]):
            if f["uri"] in outputs and "sources" in records.get(
                    f["uri"], {}) and r.index not in first:
                first[r.index] = (f["uri"], r)
    values: Dict[str, float] = {}
    for index in CHECKED:
        if index not in first:
            continue
        uri, rec = first[index]
        start = time.perf_counter()
        found = numbers(ctx, weights, ctx.traffic.audio(rec), records[uri],
                        outputs[uri])
        output = outputs[uri]
        ctx.log(f"checked {uri} ({rec.seconds:.1f} s, "
                f"{ctx.traffic.voices(rec)} voices; the program's "
                f"{len(output.speaker_diarization.labels())} speakers, "
                f"{len(list(output.speaker_diarization.itertracks()))} "
                f"segments) in {time.perf_counter() - start:.3f} s: {found}")
        for name, value in found.items():
            values[name] = max(values.get(name, value), value)
    return values


def control(ctx, weights, mode: str, files: int = None):
    """The plain model in ``mode`` put in the program's place, for the
    recordings a run's check reads from the pool: its scores, sources,
    WavLM state and embeddings (under its own masks) against the float32
    reference's, and its separated sources through the reference's tail
    (its own clusters and reconstruction) against the float32 sources
    through the same tail: -> [(uri, seconds, numbers)]."""
    config = ctx.config
    spec = config["segmentation"]
    low = Numerics(mode)
    p = weights["segmentation"]
    threshold = config["instantiate"]["segmentation"]["threshold"]
    by_index = {r.index: r for r in ctx.traffic.pool}
    out = []
    for index in checked_pool(ctx.traffic, ctx.seed,
                              files or config["check_files"]):
        rec = by_index[index]
        start = time.perf_counter()
        audio = ctx.traffic.audio(rec)
        window, step, chunks, padded = _grid(config, len(audio))
        x = _padded(audio, padded, ctx.device)
        found = {}
        found["score_gap"], found["source_gap"], scores, sources, \
            reference = _model_gaps(config, p, x, window, step, None, None,
                                    low)
        first = x.unfold(0, window, step)[:min(
            config["segmentation_batch_size"], chunks)]
        found["ssl_gap"] = float(totatonet.unit_gap(
            totatonet.ssl_output(spec, p, first, low),
            totatonet.ssl_output(spec, p, first, Numerics("float32"))).max())
        binarized = (scores > threshold).float().cpu().numpy()
        starts = np.arange(chunks, dtype=np.int64) * step
        ours = _embeddings(config, weights, x, starts, window, binarized,
                           len(audio), low)
        found["emb_gap"] = _emb_gap(ours.cpu().numpy(), _embeddings(
            config, weights, x, starts, window, binarized, len(audio),
            Numerics("float32")), binarized)
        alone = binarized.sum(axis=2, keepdims=True) == 1
        hard, _ = clustering.method(
            config["clustering"]["kind"], config["instantiate"]["clustering"],
            weights)(ours.double().cpu().numpy(), (binarized * alone).sum(
                axis=1), binarized.sum(axis=1), binarized.shape[1])
        normal, _, _, hard = _reconstruction(config, scores.cpu().numpy(),
                                             binarized, hard)
        frame_duration, frame_step = totatonet.frames(spec)
        runs = totatonet.labelled_runs(normal, normal, frame_duration,
                                       frame_step)
        labelled = {}
        for a, b, label in runs:
            labelled.setdefault(label, []).append((a, b))
        clusters = totatonet.present(normal)
        args = (hard, starts, len(audio), labelled, clusters,
                spec["hparams"]["sample_rate"],
                config["instantiate"]["separation"]["asr_collar"])
        mine = totatonet.tail(sources, *args)
        theirs = totatonet.tail(reference, *args)
        del scores, sources, reference
        found["separated_gap"] = max(
            [totatonet.relative_l2(mine[:, i], theirs[:, i])
             for i in range(mine.shape[1])], default=0.0)
        ctx.log(f"control {mode} seed {ctx.seed} pool_{index:02d} "
                f"({rec.seconds:.1f} s) in "
                f"{time.perf_counter() - start:.3f} s: {found}")
        out.append((f"pool_{index:02d}", rec.seconds, found))
    return out
