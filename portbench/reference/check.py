"""The comparison that decides ``correct``.

For each recording of the sample, what the program produced on the timed
path is held against the plain reference:

- ``logp_mean_gap``: the mean gap between the program's segmentation
  log-probs (the model's output, every chunk, frame and powerset class)
  and the reference's over the same chunks of the same audio, and
  ``logp_chunk_gap`` the widest mean over one chunk's frames and classes
  (``logp_gap``, the widest single gap, is logged and not compared: on
  random weights it saturates, ``PERF.md`` §2);
- ``decode_mismatch``: frames whose hard segmentation, as the program
  passed it on, is not the powerset decoding of the program's own
  log-probs;
- ``ssl_gap`` (SSeRiouSS): the widest relative L2 gap, frame by frame,
  between the SSL trunk's last layer as the program computed it for the
  first segmentation batch of the recording and the reference's;
- ``emb_gap``: the widest relative L2 gap between the program's
  embedding of an active (chunk, local speaker) pair and the reference's,
  under the masks the program's hard segmentation gives;
- ``count_mismatch``: frame-level speaker counts and per-(chunk,
  speaker) active and alone frame counts that differ from the reference's
  computed from the program's hard segmentation;
- ``cluster_mismatch``: active pairs whose cluster differs from the
  reference clustering of the program's embeddings, where the program's
  choice scores lower by more than a tie under the reference's scores
  (``clustering.moved``);
- ``annotation_mismatch``: segments of the program's diarization and
  exclusive diarization absent from the reference reconstruction (from
  the program's hard segmentation, clusters and count) or the reverse.

Those last three follow the program's own intermediate results, stage by
stage: each stage is held to the reference given the program's input to
it, and the first two stages (segmentation, embeddings) are held from
the raw audio. For the longest recording the reference also runs alone
from the raw audio, seeing nothing the program produced
(``end_to_end_numbers``): ``emb_gap_e2e`` is compared;
``cluster_gap_e2e`` and ``mask_disagreement`` are logged, since the
control reads them at no three times the program's (``PERF.md`` §2).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .clustering import moved
from .numerics import Numerics
from .pipeline import ReferencePipeline

TIME_TOLERANCE = 1e-6


def segmentation_numbers(ref: ReferencePipeline, samples: np.ndarray,
                         logp: torch.Tensor, binarized: torch.Tensor,
                         reference_logp: torch.Tensor) -> Dict[str, float]:
    logp = logp.to(reference_logp.device, torch.float32)
    decoded = ref.binarize(logp)
    gap = (logp - reference_logp).abs()
    return {"logp_gap": float(gap.max()),
            "logp_mean_gap": float(gap.mean()),
            "logp_chunk_gap": float(gap.mean(dim=(1, 2)).max()),
            "decode_mismatch": int((decoded != binarized.to(
                decoded.device)).any(dim=-1).sum())}


def ssl_numbers(ref: ReferencePipeline, samples: np.ndarray,
                ours: torch.Tensor) -> Dict[str, float]:
    theirs = ref.ssl_output(samples, len(ours), Numerics("float32"))
    ours = ours.to(theirs.device, torch.float32)
    gap = (ours - theirs).norm(dim=-1) / theirs.norm(dim=-1).clamp(
        min=1e-12)
    return {"ssl_gap": float(gap.max())}


def embedding_numbers(ref: ReferencePipeline, samples: np.ndarray,
                      binarized: torch.Tensor, embeddings: np.ndarray
                      ) -> Dict[str, float]:
    theirs = ref.embeddings(samples, binarized.to(ref.device).float(),
                            Numerics("float32")).double().cpu().numpy()
    active = binarized.sum(dim=1).cpu().numpy() > 0           # (C, S)
    ours = np.asarray(embeddings, dtype=np.float64)
    gap = np.linalg.norm(ours - theirs, axis=-1) / np.maximum(
        np.linalg.norm(theirs, axis=-1), 1e-12)
    return {"emb_gap": float(gap[active].max()) if active.any() else 0.0}


def _segments(annotation) -> List[Tuple[float, float, str]]:
    return sorted((segment.start, segment.end, str(label)) for segment, _,
                  label in annotation.itertracks(yield_label=True))


def _on_grid(segments, t0: float, step: float):
    """Each segment as (label, first frame, end frame) on the output grid,
    or None where an end lies off the grid by more than TIME_TOLERANCE."""
    out = []
    for start, end, label in segments:
        a, b = round((start - t0) / step), round((end - t0) / step)
        if abs(t0 + a * step - start) > TIME_TOLERANCE or \
                abs(t0 + b * step - end) > TIME_TOLERANCE:
            out.append(None)
        else:
            out.append((label, a, b))
    return out


def _unmatched(ours: list, theirs: list, t0: float, step: float) -> int:
    """Segments of either side with no equal segment (same label, both
    ends on the same frame centre) on the other."""
    a = Counter(_on_grid(ours, t0, step))
    b = Counter(_on_grid(theirs, t0, step))
    off = a.pop(None, 0) + b.pop(None, 0)
    return off + sum(((a - b) + (b - a)).values())


def downstream_numbers(ref: ReferencePipeline, record: dict
                       ) -> Dict[str, float]:
    binarized = record["binarized"].float().cpu().numpy()
    speaker_frames = binarized.sum(axis=1)
    alone = binarized.sum(axis=2, keepdims=True) == 1
    clean_frames = (binarized * alone).sum(axis=1)
    count = ref.count(binarized)
    program_count = record["count"].reshape(-1).astype(np.int64)
    stats = int(np.sum(speaker_frames != record["speaker_frames"])
                + np.sum(clean_frames != record["clean_frames"]))
    counted = stats + int(np.sum(count != program_count)) \
        + abs(len(count) - len(program_count))
    active = speaker_frames > 0
    clusters, soft = ref.cluster(record["embeddings"],
                                 record["clean_frames"],
                                 record["speaker_frames"], binarized.shape[1])
    cluster_mismatch = moved(record["hard"], clusters, soft, active,
                             per_chunk=ref.clusterer.per_chunk)
    mismatch = 0
    output = record["output"]
    for exclusive, annotation in (
            (False, output.speaker_diarization),
            (True, output.exclusive_speaker_diarization)):
        theirs = ref.annotation(binarized, record["hard"], program_count,
                                record["speaker_frames"], exclusive)
        mismatch += _unmatched(_segments(annotation), theirs,
                               0.5 * ref.frame_duration, ref.frame_step)
    return {"count_mismatch": counted, "cluster_mismatch": cluster_mismatch,
            "annotation_mismatch": mismatch}


def matched_disagreement(ours: np.ndarray, theirs: np.ndarray) -> float:
    """Share of entries whose label differs, once ``ours``'s labels are
    mapped one to one onto ``theirs``'s (Hungarian on the contingency
    table; an unmatched label counts as wrong)."""
    if len(ours) == 0:
        return 0.0
    a = np.unique(ours, return_inverse=True)[1]
    b = np.unique(theirs, return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(table, (a, b), 1)
    rows, cols = linear_sum_assignment(table, maximize=True)
    return float(1.0 - table[rows, cols].sum() / len(ours))


def end_to_end_numbers(ref: ReferencePipeline, samples: np.ndarray,
                       record: dict, reference_logp: torch.Tensor
                       ) -> Dict[str, float]:
    """The reference alone from the raw audio (its own segmentation,
    masks, embeddings and clustering), held against what the program
    produced: ``mask_disagreement`` the share of (chunk, local speaker)
    pairs active on either side whose embedding masks differ;
    ``emb_gap_e2e`` the widest relative L2 gap of an embedding whose masks
    agree; ``cluster_gap_e2e`` the share of pairs active on both sides in
    another cluster, the two sides' cluster labels matched one to one."""
    theirs = ref.binarize(reference_logp)
    ours = record["binarized"].to(theirs.device)
    agree = (ref.masks(theirs.float()) == ref.masks(ours.float())).all(
        dim=-1).cpu().numpy()                                    # (C, S)
    with torch.inference_mode():
        embeddings = ref.embeddings(samples, theirs.float(),
                                    Numerics("float32")).double().cpu()
    binarized = theirs.float().cpu().numpy()
    speaker_frames = binarized.sum(axis=1)
    alone = binarized.sum(axis=2, keepdims=True) == 1
    clean_frames = (binarized * alone).sum(axis=1)
    clusters, _ = ref.cluster(embeddings.numpy(), clean_frames,
                              speaker_frames, binarized.shape[1])
    active = speaker_frames > 0
    program_active = ours.sum(dim=1).cpu().numpy() > 0
    either, both = active | program_active, active & program_active
    program = np.asarray(record["embeddings"], dtype=np.float64)
    gap = np.linalg.norm(program - embeddings.numpy(), axis=-1) / np.maximum(
        np.linalg.norm(embeddings.numpy(), axis=-1), 1e-12)
    compared = both & agree
    return {"mask_disagreement": float((either & ~agree).sum()
                                       / max(either.sum(), 1)),
            "emb_gap_e2e": float(gap[compared].max())
            if compared.any() else 0.0,
            "cluster_gap_e2e": matched_disagreement(record["hard"][both],
                                                    clusters[both]),
            "clusters": int(len(np.unique(clusters[active])))}


def numbers(ref: ReferencePipeline, samples: np.ndarray, record: dict,
            seconds: Dict[str, float] = None, end_to_end: bool = False
            ) -> Dict[str, float]:
    """Every number compared, for one recording the program finished
    (with ``end_to_end``, also the reference alone's); ``seconds`` gets
    the time each stage of the check took."""
    seconds = {} if seconds is None else seconds
    start = time.perf_counter()
    reference_logp = ref.logprobs(samples, Numerics("float32"))
    out = segmentation_numbers(ref, samples, torch.cat(record["logp"]),
                               record["binarized"], reference_logp)
    if "ssl" in record:
        out.update(ssl_numbers(ref, samples, record["ssl"]))
    seconds["segmentation"] = time.perf_counter() - start
    out.update(embedding_numbers(ref, samples, record["binarized"],
                                 record["embeddings"]))
    seconds["embeddings"] = time.perf_counter() - start - sum(
        seconds.values())
    out.update(downstream_numbers(ref, record))
    seconds["downstream"] = time.perf_counter() - start - sum(
        seconds.values())
    if end_to_end:
        out.update(end_to_end_numbers(ref, samples, record, reference_logp))
        seconds["end_to_end"] = time.perf_counter() - start - sum(
            seconds.values())
    return out


def control_numbers(ref: ReferencePipeline, samples: np.ndarray,
                    mode: str) -> Dict[str, float]:
    """The reference in ``mode`` put in the program's place: its
    log-probs and embeddings held against the float32 reference's, as the
    program's are."""
    low = Numerics(mode)
    logp = ref.logprobs(samples, low)
    binarized = ref.binarize(logp)
    reference_logp = ref.logprobs(samples, Numerics("float32"))
    out = segmentation_numbers(ref, samples, logp, binarized, reference_logp)
    states = ref.ssl_output(
        samples, min(ref.config["segmentation_batch_size"], len(logp)), low)
    if states is not None:
        out.update(ssl_numbers(ref, samples, states))
    with torch.inference_mode():
        embeddings = ref.embeddings(samples, binarized.float(), low)
    out.update(embedding_numbers(ref, samples, binarized,
                                 embeddings.cpu().numpy()))
    b = binarized.float().cpu().numpy()
    alone = b.sum(axis=2, keepdims=True) == 1
    hard, _ = ref.cluster(embeddings.double().cpu().numpy(),
                          (b * alone).sum(axis=1), b.sum(axis=1), b.shape[1])
    out.update(end_to_end_numbers(ref, samples, {
        "binarized": binarized, "embeddings": embeddings.cpu().numpy(),
        "hard": hard}, reference_logp))
    return out
