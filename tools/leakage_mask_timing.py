"""Time the separation pipeline's leakage removal on one long recording.

    python3 tools/leakage_mask_timing.py [--minutes 15] [--speakers 3] \
        [--collar 0.32] [--repeats 3] [--out FILE]

Draws a diarization of ``--speakers`` speakers over ``--minutes`` of
16-kHz audio (1-6 s turns, 0.2-2 s pauses, 15 % of turns overlapped, as
the benchmark's mixes) and (samples, speakers) float32 sources, then times
``apply_leakage_mask`` (``pipelines/speech_separation.py``, its dilation
linear in the samples) against the same mask dilated by scipy's
``binary_dilation`` with a structure of ``2 * collar`` ones (what the
function computed before, O(samples x collar)), once, and checks that
both give equal arrays. Prints one JSON line (appended to ``--out`` where
given). Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scipy.ndimage import binary_dilation  # noqa: E402

from pyannote_audio_tpu_torch.core.annotation import Annotation  # noqa: E402
from pyannote_audio_tpu_torch.core.segment import Segment  # noqa: E402
from pyannote_audio_tpu_torch.pipelines.speech_separation import \
    apply_leakage_mask  # noqa: E402

SR = 16000


def diarization(minutes: float, speakers: int, seed: int) -> Annotation:
    rng = np.random.default_rng(seed)
    out = Annotation(uri="timing")
    t, end = 0.0, minutes * 60.0
    while t < end:
        turn = rng.uniform(1.0, 6.0)
        k = int(rng.integers(speakers))
        out[Segment(t, min(end, t + turn))] = k
        if rng.random() < 0.15:
            other = (k + 1 + int(rng.integers(speakers - 1))) % speakers
            a = t + rng.uniform(0.0, turn / 2)
            out[Segment(a, min(end, a + rng.uniform(0.5, turn)))] = other
        t += turn + rng.uniform(0.2, 2.0)
    return out


def scipy_leakage_mask(sources, annotation, collar_s: float):
    num_samples, num_clusters = sources.shape
    collar = int(round(collar_s * SR))
    out = sources.copy()
    for k in range(num_clusters):
        active = np.zeros(num_samples, dtype=bool)
        for segment, _, label in annotation.itertracks(yield_label=True):
            if label == k:
                active[max(0, int(segment.start * SR)):
                       min(num_samples, int(segment.end * SR))] = True
        if collar > 0:
            active = binary_dilation(active, structure=np.ones(2 * collar))
        out[~active, k] = 0.0
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="tools/leakage_mask_timing.py")
    parser.add_argument("--minutes", type=float, default=15.0)
    parser.add_argument("--speakers", type=int, default=3)
    parser.add_argument("--collar", type=float, default=0.32)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    annotation = diarization(args.minutes, args.speakers, args.seed)
    samples = int(args.minutes * 60 * SR)
    sources = np.random.default_rng(args.seed + 1).standard_normal(
        (samples, args.speakers)).astype(np.float32)
    linear = []
    for _ in range(args.repeats):
        start = time.perf_counter()
        fast = apply_leakage_mask(sources, annotation, SR,
                                  asr_collar=args.collar)
        linear.append(time.perf_counter() - start)
    start = time.perf_counter()
    slow = scipy_leakage_mask(sources, annotation, args.collar)
    scipy_s = time.perf_counter() - start
    line = {"minutes": args.minutes, "speakers": args.speakers,
            "collar_s": args.collar, "samples": samples,
            "active_share": float((fast != 0).mean()),
            "linear_s": linear, "scipy_s": scipy_s,
            "ratio_pct": 100.0 * min(linear) / scipy_s,
            "equal": bool(np.array_equal(fast, slow))}
    print(json.dumps(line), flush=True)
    if args.out:
        path = ROOT / args.out
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a") as f:
            f.write(json.dumps(line) + "\n")
    return 0 if line["equal"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
