"""The one traffic generator: a pool of synthetic recordings and the lists
a batch job hands the pipeline, from a mix's parameters and a seed.

A mix is a JSON file beside this one (``<mix>.json``) with:

- ``pool_files``: recordings in the pool;
- ``median_minutes``, ``sigma``, ``min_minutes``, ``max_minutes``: their
  lengths are the lognormal distribution's quantiles at (i + 0.5) /
  pool_files, clipped. The lengths are the same for every seed, so that
  every seed asks for the same work; the seed orders the files and draws
  their speech;
- ``files_per_list``: files in one list. The pool is sorted by length
  into strata of equal size; each list takes the same number of files
  from each stratum, each stratum's files in seeded turns, so that lists
  hold similar audio. ``Traffic.round`` lists (the least common
  multiple of the pool and the list, in lists) take every recording of
  the pool equally often; a run's window ends only after whole rounds,
  so that every run does the same work;
- ``sample_rate``: of the PCM16 WAV files;
- ``speakers``: [fewest, most] speakers in one recording;
- ``f0_bands``: [lowest, highest] f0 of each pitch band (low and high
  male, female voices); each speaker of a recording speaks in a band of
  its own, at an f0 drawn log-uniformly within it, so that no two
  recordings share a voice and a recording has at most as many speakers
  as bands;
- ``harmonics``: [least, most] weight of a voice's second and third
  harmonic (its timbre), drawn for each voice;
- ``calibration``: the labelled recordings that set-up fits the models'
  heads on (``portbench/calibration.py``);
- ``turn_seconds``, ``gap_seconds``: [shortest, longest] of a turn and of
  the pause after it; ``overlap_share``: share of turns that a second
  speaker talks over.

The speech is the recipe of ``chip_smoke.py``'s ``synth`` (itself that of
the JAX package's ``bench.py``: a noise floor, harmonic voices with a
syllable-rate envelope, PCM16-exact), with every voice, turn and pause
drawn from the seed and the recording's index, and the samples computed
on the card in a few large operations.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Recording:
    index: int
    samples: int
    path: Path
    rate: int

    @property
    def seconds(self) -> float:
        return self.samples / self.rate


def load_mix(name: str, directory: Path = HERE) -> dict:
    """The mix ``<directory>/<name>.json``."""
    return json.loads((directory / f"{name}.json").read_text())


def pool_lengths(mix: dict) -> List[int]:
    """Sample counts of the pool's recordings, shortest first."""
    n, rate = mix["pool_files"], mix["sample_rate"]
    normal = NormalDist()
    out = []
    for i in range(n):
        z = normal.inv_cdf((i + 0.5) / n)
        minutes = mix["median_minutes"] * math.exp(mix["sigma"] * z)
        minutes = min(max(minutes, mix["min_minutes"]), mix["max_minutes"])
        out.append(int(round(minutes * 60 * rate)))
    return out


# the columns of ``turns``'s rows
FIRST, END, F0, RATE, PHASE, SECOND, THIRD, VOICE, BAND = range(9)


def draw_voices(rng: np.random.Generator, mix: dict) -> np.ndarray:
    """(voices, 4): f0, second and third harmonic weights, and the pitch
    band, of a recording's speakers."""
    lo, hi = mix["speakers"]
    count = int(rng.integers(lo, hi + 1))
    bands = rng.choice(len(mix["f0_bands"]), size=count, replace=False)
    edges = np.log(np.array(mix["f0_bands"], dtype=np.float64)[bands])
    f0 = np.exp(rng.uniform(edges[:, 0], edges[:, 1]))
    harmonics = rng.uniform(*mix["harmonics"], size=(count, 2))
    return np.column_stack([f0, harmonics, bands])


def turns(samples: int, rng: np.random.Generator, mix: dict):
    """The recording's voiced stretches, one row per voice of each turn,
    with the columns FIRST (sample), END, F0, RATE (of the envelope),
    PHASE, SECOND and THIRD (harmonic weights), VOICE (the speaker's
    index in the recording) and BAND (its pitch band)."""
    rate = mix["sample_rate"]
    voices = draw_voices(rng, mix)
    t_lo, t_hi = mix["turn_seconds"]
    g_lo, g_hi = mix["gap_seconds"]
    start = rng.uniform(0.0, g_hi)
    speaker = 0
    rows = []
    while start * rate < samples:
        length = rng.uniform(t_lo, t_hi)
        turn = [speaker]
        if rng.random() < mix["overlap_share"] and len(voices) > 1:
            turn.append(int((speaker + rng.integers(1, len(voices)))
                            % len(voices)))
        i0 = int(start * rate)
        i1 = min(samples, int((start + length) * rate))
        for k in turn:
            f0, second, third, band = voices[k]
            rows.append((i0, i1, f0, rng.uniform(3.0, 5.0),
                         rng.uniform(0, 2 * np.pi), second, third, k, band))
        start += length + rng.uniform(g_lo, g_hi)
        speaker = int((speaker + rng.integers(1, len(voices)))
                      % len(voices)) if len(voices) > 1 else 0
    return np.array(rows, dtype=np.float64).reshape(-1, 9)


def synth(samples: int, rng: np.random.Generator, mix: dict, noise_seed: int,
          device, rows: np.ndarray = None) -> np.ndarray:
    """One recording as PCM16 samples, computed on ``device``: a noise
    floor of N(0, 0.003^2) and each voice's fundamental with its two
    harmonics under a syllable-rate envelope. ``rows`` are the
    recording's ``turns``, drawn from ``rng`` where not given."""
    import torch
    if rows is None:
        rows = turns(samples, rng, mix)
    rows = torch.as_tensor(rows, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(noise_seed)
    wav = 0.003 * torch.randn(samples, generator=g, device=device)
    i0, i1 = rows[:, FIRST].long(), rows[:, END].long()
    lengths = (i1 - i0).clamp(min=0)
    entry = torch.repeat_interleave(torch.arange(len(rows), device=device),
                                    lengths)
    first = torch.cumsum(lengths, 0) - lengths
    offset = torch.arange(len(entry), device=device) - first[entry]
    t = offset.float() / mix["sample_rate"]
    theta = 2 * np.pi * rows[entry, F0].float() * t \
        + rows[entry, PHASE].float()
    s1, c1 = torch.sin(theta), torch.cos(theta)
    voice = s1 + rows[entry, SECOND].float() * (2 * s1 * c1) \
        + rows[entry, THIRD].float() * (3 * s1 - 4 * s1 ** 3)
    envelope = 0.5 + 0.5 * torch.sin(2 * np.pi * rows[entry, RATE].float()
                                     * t).abs()
    wav.index_add_(0, i0[entry] + offset, 0.12 * voice * envelope)
    return (wav * 32768.0).round().clamp(-32768, 32767).to(
        torch.int16).cpu().numpy()


def write_wav(path: Path, pcm: np.ndarray, rate: int) -> None:
    """A mono PCM16 RIFF/WAVE file."""
    data = pcm.astype("<i2").tobytes()
    header = b"".join([
        b"RIFF", (36 + len(data)).to_bytes(4, "little"), b"WAVE",
        b"fmt ", (16).to_bytes(4, "little"), (1).to_bytes(2, "little"),
        (1).to_bytes(2, "little"), rate.to_bytes(4, "little"),
        (2 * rate).to_bytes(4, "little"), (2).to_bytes(2, "little"),
        (16).to_bytes(2, "little"), b"data", len(data).to_bytes(4, "little")])
    path.write_bytes(header + data)


def pcm_to_float(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.float32) / np.float32(32768.0)


def seeded(seed: int, *keys: int) -> np.random.Generator:
    """A generator for ``seed`` (any non-negative integer) and ``keys``."""
    return np.random.default_rng([seed % 2 ** 63, seed >> 63, *keys])


class Traffic:
    """A mix's pool, written as WAV files into ``workdir``, and its
    lists."""

    def __init__(self, mix: dict, seed: int, workdir: Path):
        self.mix, self.seed = mix, seed
        lengths = pool_lengths(mix)
        order = seeded(seed, 0).permutation(len(lengths))
        self.pool: List[Recording] = []
        for slot, i in enumerate(order):
            path = workdir / f"pool_{slot:02d}.wav"
            self.pool.append(Recording(slot, lengths[i], path,
                                       mix["sample_rate"]))

    def write(self, device="cpu") -> None:
        """Every recording of the pool, synthesised on ``device``."""
        for rec in self.pool:
            pcm = synth(rec.samples, seeded(self.seed, 1, rec.index),
                        self.mix, (self.seed * 1000003 + rec.index) % 2 ** 63,
                        device)
            write_wav(rec.path, pcm, self.mix["sample_rate"])

    def voices(self, rec: Recording) -> int:
        """Speakers in the recording."""
        return len(draw_voices(seeded(self.seed, 1, rec.index), self.mix))

    def audio(self, rec: Recording) -> np.ndarray:
        """The recording as the reference reads it: float32 samples."""
        raw = np.fromfile(rec.path, dtype="<i2", offset=44)
        return pcm_to_float(raw)

    @property
    def round(self) -> int:
        """Lists that together take every recording equally often."""
        n, per = len(self.pool), self.mix["files_per_list"]
        return n * per // math.gcd(n, per) // per

    def strata(self) -> List[List[Recording]]:
        n, per = len(self.pool), self.mix["files_per_list"]
        count = math.gcd(n, per)
        ranked = sorted(self.pool, key=lambda r: (r.samples, r.index))
        size = n // count
        return [ranked[k * size:(k + 1) * size] for k in range(count)]

    def lists(self) -> Iterator[List[Recording]]:
        """Lists without end: each takes files_per_list / strata files
        from every stratum, in seeded turns through each stratum."""
        strata = self.strata()
        take = self.mix["files_per_list"] // len(strata)
        queues = [[] for _ in strata]
        rng = seeded(self.seed, 2)
        while True:
            chosen = []
            for queue, stratum in zip(queues, strata):
                for _ in range(take):
                    if not queue:
                        queue.extend(stratum[i] for i in
                                     rng.permutation(len(stratum)))
                    chosen.append(queue.pop(0))
            yield [chosen[i] for i in rng.permutation(len(chosen))]
