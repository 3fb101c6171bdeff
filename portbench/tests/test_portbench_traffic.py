"""The traffic generator: deterministic by seed, the same sizes for every
seed, balanced lists."""

from collections import Counter
from itertools import islice

import numpy as np

from portbench.traffic.generator import Traffic, load_mix, pool_lengths


def _lists(traffic, n):
    return [[r.index for r in lst] for lst in islice(traffic.lists(), n)]


def test_same_seed_same_traffic(tmp_path, tiny_mix):
    a = Traffic(tiny_mix, 2 ** 40 + 7, tmp_path / "a")
    b = Traffic(tiny_mix, 2 ** 40 + 7, tmp_path / "b")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a.write()
    b.write()
    assert [r.samples for r in a.pool] == [r.samples for r in b.pool]
    assert _lists(a, 5) == _lists(b, 5)
    for x, y in zip(a.pool, b.pool):
        assert np.array_equal(a.audio(x), b.audio(y))


def test_seeds_share_sizes_not_order_or_speech(tmp_path, tiny_mix):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = Traffic(tiny_mix, 1, tmp_path / "a")
    b = Traffic(tiny_mix, 2, tmp_path / "b")
    assert sorted(r.samples for r in a.pool) == \
        sorted(r.samples for r in b.pool)
    a.write()
    b.write()
    longest = max(a.pool, key=lambda r: r.samples)
    twin = next(r for r in b.pool if r.samples == longest.samples)
    assert not np.array_equal(a.audio(longest), b.audio(twin))


def test_pool_lengths_follow_the_lognormal_quantiles():
    mix = load_mix("lists16")
    minutes = np.array(pool_lengths(mix)) / 16000 / 60
    assert len(minutes) == 24
    assert minutes.min() >= 1.0 and minutes.max() <= 15.0
    assert abs(np.median(minutes) - 5.0) < 0.5
    assert np.all(np.diff(minutes) >= 0)


def test_lists_take_every_stratum_equally(tmp_path):
    for name, per in (("lists16", 2), ("lists4", 1)):
        mix = load_mix(name)
        traffic = Traffic(mix, 123, tmp_path)
        strata = traffic.strata()
        where = {r.index: k for k, stratum in enumerate(strata)
                 for r in stratum}
        for lst in _lists(traffic, 12):
            assert len(lst) == mix["files_per_list"]
            assert set(Counter(where[i] for i in lst).values()) == {per}


def test_speech_is_pcm16_exact(tmp_path, tiny_mix):
    traffic = Traffic(tiny_mix, 5, tmp_path)
    traffic.write()
    audio = traffic.audio(traffic.pool[0])
    assert audio.dtype == np.float32
    assert np.array_equal(np.round(audio * 32768) / 32768, audio)
    assert np.abs(audio).max() > 0.05


def test_a_round_takes_every_recording_equally_often(tmp_path):
    for name, lists in (("lists16", 3), ("lists4", 6)):
        traffic = Traffic(load_mix(name), 2 ** 40 + 3, tmp_path)
        assert traffic.round == lists
        for k in range(2):
            taken = Counter(i for lst in _lists(traffic, (k + 1) * lists)
                            [k * lists:] for i in lst)
            assert set(taken) == {r.index for r in traffic.pool}
            assert len(set(taken.values())) == 1


def test_a_recordings_speakers_have_pitch_bands_of_their_own():
    from portbench.traffic.generator import BAND, VOICE, seeded, turns
    mix = load_mix("lists16")
    for k in range(20):
        rows = turns(16000 * 60, seeded(7, 1, k), mix)
        bands = {int(v): int(b) for v, b in rows[:, [VOICE, BAND]]}
        lo, hi = mix["speakers"]
        assert lo <= len(bands) <= hi
        assert len(set(bands.values())) == len(bands)
