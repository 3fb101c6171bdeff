"""The benchmark's operation and byte counts against hand arithmetic."""

import json

import pytest

from portbench import diarization, flops
from portbench.harness import ROOT


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_chunk_grid():
    assert flops.chunk_grid(160000, 160000, 16000) == (1, 160000)
    assert flops.chunk_grid(160001, 160000, 16000) == (2, 176000)
    assert flops.chunk_grid(100, 160000, 16000) == (1, 160000)
    assert flops.chunk_grid(320000, 160000, 16000) == (11, 320000)


def test_lstm_flops_by_hand():
    # 2 directions x 2 FLOPs a MAC x steps x 4H (I + H)
    assert flops.lstm_flops(10, [60], 128) == 2 * 2 * 10 * 4 * 128 * 188
    assert flops.lstm_flops(1, [60, 256], 8) == \
        2 * 2 * (4 * 8 * 68 + 4 * 8 * 264)


def test_pyannet_frames_and_flops():
    per_chunk, steps = flops.pyannet_chunk_flops(160000, 10, 128, 2, 128, 2,
                                                 7)
    assert steps == 589
    f = (160000 - 251) // 10 + 1
    f //= 3
    convs = 2 * 5 * 80 * 60 * (f - 4)
    f = (f - 4) // 3
    convs += 2 * 5 * 60 * 60 * (f - 4)
    lstm = 2 * 2 * 589 * (4 * 128 * (60 + 128) + 4 * 128 * (256 + 128))
    head = 2 * 589 * (256 * 128 + 128 * 128 + 128 * 7)
    assert per_chunk == convs + lstm + head


def test_wavlm_frames():
    config = _config("sseriouss-wavlm-base")
    flops_, frames = flops.wavlm_chunk_flops(160000,
                                             config["segmentation"]["ssl"])
    assert frames == 499
    # the transformer layers dominate: 12 x (4 d^2 + 2 d ffn) MACs a frame
    layers = 12 * 2 * (4 * 768 * 768 + 2 * 768 * 3072) * 499
    assert layers < flops_ < 3 * layers


def test_lstm_bound_by_hand():
    T, B, H, D = 589, 256, 128, 2
    moved = 4 * T * B * D * 4 * H + 4 * T * B * D * H + D * 4 * H * H * 2
    assert flops.lstm_bound(T, B, H, D, "default") == \
        pytest.approx(moved / 3.35e12)
    assert flops.lstm_bound(T, B, H, D, "highest") == \
        pytest.approx(2 * T * B * D * 4 * H * H / 67e12)


def test_lstm_launches_follow_the_batches():
    config = _config("community1")
    # 5 min: 291 chunks, nine batches of 32 and a tail of 3, four layers
    assert diarization.lstm_launches(config, 300 * 16000) == \
        [(589, 32)] * 4 * 9 + [(589, 3)] * 4
    sseriouss = _config("sseriouss-wavlm-base")
    assert len(diarization.lstm_launches(sseriouss, 300 * 16000)) == 4 * 10


def test_recording_flops_count_no_padding():
    """The benchmark's count stays at or under what the port's own count
    (which models padded execution) gives for the same recording."""
    from pyannote_audio_tpu_torch.utils.flops import (
        diarization_device_flops, total_flops)
    config = _config("community1")
    for seconds in (61.0, 300.0, 899.5):
        ours = sum(diarization.recording_flops(config, int(seconds * 16000))
                   .values())
        assert 0 < ours <= total_flops(diarization_device_flops(seconds))
