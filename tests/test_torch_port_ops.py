"""The port's diarization ops against the JAX package, exactly.

Count, activity statistics, pooling masks and reconstruction sum 0/1
values (exact in float32 in any order) and rank with a stable sort, so
the port must reproduce the JAX results bit for bit, NaN-stitched
columns included. The JAX side runs on bucket-padded chunks, as in its
pipeline; the port on the exact chunk count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_audio_tpu.core.inference import _chunk_grid as jax_grid
from pyannote_audio_tpu.ops import diarize_fused as jax_fused
from pyannote_audio_tpu.ops.aggregate import _bucket, pad_chunk_bucket
from pyannote_audio_tpu.ops.powerset import Powerset as JaxPowerset
from pyannote_audio_tpu_torch.core.inference import _chunk_grid
from pyannote_audio_tpu_torch.ops import diarize_fused
from pyannote_audio_tpu_torch.ops.powerset import Powerset


def _binarized(num_chunks=37, num_frames=29, num_speakers=3, seed=0,
               nan=True):
    rng = np.random.default_rng(seed)
    scores = (rng.uniform(size=(num_chunks, num_frames, num_speakers))
              > 0.55).astype(np.float32)
    if nan:
        # NaN-stitched columns: a speaker missing over part of a chunk
        scores[3, 5:12, 1] = np.nan
        scores[10, :, 2] = np.nan
        scores[20, 0, :] = np.nan
    # overlapping chunks, offsets drifting by +-1 frame like closest_frame
    offsets = (np.arange(num_chunks) * 3
               + rng.integers(0, 2, num_chunks)).astype(np.int32)
    num_output_frames = int(offsets[-1]) + num_frames
    return scores, offsets, num_output_frames


@pytest.mark.parametrize("nan", [True, False])
def test_fused_count_stats_exact(nan):
    scores, offsets, n_out = _binarized(nan=nan)
    C = len(scores)
    dev, offsets_p, mask = pad_chunk_bucket(jnp.asarray(scores), offsets, C)
    count, speaker_frames, clean_frames = (
        np.asarray(a) for a in jax_fused.fused_count_stats(
            dev, jnp.asarray(offsets_p), jnp.asarray(mask),
            _bucket(n_out, 4096)))
    ours = diarize_fused.fused_count_stats(
        torch.from_numpy(scores), torch.from_numpy(offsets), n_out)
    np.testing.assert_array_equal(ours[0].numpy(), count[:n_out])
    assert ours[0].dtype == torch.uint8
    np.testing.assert_array_equal(ours[1].numpy(), speaker_frames[:C])
    np.testing.assert_array_equal(ours[2].numpy(), clean_frames[:C])


@pytest.mark.parametrize("exclude_overlap", [False, True])
def test_make_embedding_masks_exact(exclude_overlap):
    scores, _, _ = _binarized(seed=1)
    expected = np.asarray(jax_fused.make_embedding_masks(
        jnp.asarray(scores), exclude_overlap, 6))
    ours = diarize_fused.make_embedding_masks(torch.from_numpy(scores),
                                              exclude_overlap, 6)
    np.testing.assert_array_equal(ours.numpy(), expected)


@pytest.mark.parametrize("nan", [True, False])
def test_fused_reconstruct_exact(nan):
    scores, offsets, n_out = _binarized(seed=2, nan=nan)
    C, _, S = scores.shape
    rng = np.random.default_rng(3)
    hard = rng.integers(-2, 4, size=(C, S)).astype(np.int32)
    count = rng.integers(0, 4, size=n_out).astype(np.int32)
    num_clusters = 4
    F_bucket = _bucket(n_out, 4096)
    dev, offsets_p, mask = pad_chunk_bucket(jnp.asarray(scores), offsets, C)
    hard_p = np.full((dev.shape[0], S), -2, np.int32)
    hard_p[:C] = hard
    count_p = np.zeros(F_bucket, np.int32)
    count_p[:n_out] = count
    bits = jax_fused.fused_reconstruct(
        dev, jnp.asarray(hard_p), jnp.asarray(offsets_p), jnp.asarray(mask),
        jnp.asarray(count_p), num_clusters, F_bucket)
    expected = [jax_fused.unpack_reconstruct(np.asarray(b), F_bucket,
                                             num_clusters)[:n_out]
                for b in bits]
    ours = diarize_fused.fused_reconstruct(
        torch.from_numpy(scores), torch.from_numpy(hard),
        torch.from_numpy(offsets), torch.from_numpy(count), num_clusters,
        n_out)
    for o, e in zip(ours, expected):
        assert o.dtype == torch.bool
        np.testing.assert_array_equal(o.numpy().astype(np.float32), e)
    assert ours[0].sum() > ours[1].sum() > 0


def test_powerset_to_multilabel_matches_jax():
    logp = np.random.default_rng(4).standard_normal((5, 11, 7)).astype(
        np.float32)
    for soft in (False, True):
        expected = np.asarray(JaxPowerset(3, 2).to_multilabel(
            jnp.asarray(logp), soft=soft))
        ours = Powerset(3, 2).to_multilabel(torch.from_numpy(logp),
                                            soft=soft).numpy()
        np.testing.assert_allclose(ours, expected, atol=1e-6)


@pytest.mark.parametrize("num_samples", [16000 * 30, 16000 * 30 + 7, 80000,
                                         160000 + 16000 * 3])
def test_chunk_grid_matches_jax(num_samples):
    starts, padded = _chunk_grid(num_samples, 160000, 16000)
    expected, _ = jax_grid(num_samples, 160000, 16000, 16000)
    np.testing.assert_array_equal(starts, expected)
    assert padded == int(expected[-1]) + 160000
