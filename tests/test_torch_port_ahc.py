"""The port's device AHC (``ops/ahc.py``) against the JAX package's and
scipy's centroid linkage, on the CPU.

Inputs are seeded Gaussian blobs and random points. Held, at the bounds
of tests/test_ahc.py: sorted merge heights within rtol 5e-3 / atol 5e-4
of scipy's (float32 against float64), the same partition as scipy at a
threshold between the blobs, the last merge covering every leaf. Against
the JAX package on points with no near-tied merges: the same merge
sequence, heights within 1e-5 (the port updates one row from the new
centroid where the JAX package re-expands every distance), the same
linkage matrix up to those heights and the same flat clusters. The
agglomerative clustering pipeline with PYANNOTE_TPU_DEVICE_AHC=1 gives
the host partition.
"""

import numpy as np
import pytest
import torch
from scipy.cluster.hierarchy import fcluster, linkage

import jax.numpy as jnp
from pyannote_audio_tpu.ops import ahc as jax_ahc
from pyannote_audio_tpu_torch.ops import ahc
from pyannote_audio_tpu_torch.pipelines import clustering
from test_torch_port_vbx import port_stats, same_partition, speakers


def blobs(n_clusters=3, per=12, dim=8, spread=0.05, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)) * 4
    x = np.concatenate([centers[k] + spread * rng.standard_normal((per, dim))
                        for k in range(n_clusters)])
    truth = np.repeat(np.arange(n_clusters), per)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), truth[perm]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linkage_matches_scipy(seed):
    x, truth = blobs(seed=seed)
    ours = ahc.device_linkage(x, device="cpu")
    ref = linkage(x.astype(np.float64), method="centroid",
                  metric="euclidean")
    np.testing.assert_allclose(np.sort(ours[:, 2]), np.sort(ref[:, 2]),
                               rtol=5e-3, atol=5e-4)
    assert ours[-1, 3] == len(x)
    ours_c = fcluster(ours, 1.0, criterion="distance")
    assert same_partition(ours_c, fcluster(ref, 1.0, criterion="distance"))
    assert same_partition(ours_c, truth)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("unit_norm", [False, True])
def test_merges_match_jax(seed, unit_norm):
    x = np.random.default_rng(seed).standard_normal((60, 16)).astype(
        np.float32)
    if unit_norm:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    merges, heights = ahc.centroid_linkage(torch.from_numpy(x))
    jax_merges, jax_heights = jax_ahc.centroid_linkage(jnp.asarray(x))
    np.testing.assert_array_equal(merges.numpy(), np.asarray(jax_merges))
    np.testing.assert_allclose(heights.numpy(), np.asarray(jax_heights),
                               atol=1e-5)
    ours = ahc.linkage_matrix_from_merges(merges.numpy(), heights.numpy(),
                                          len(x))
    theirs = jax_ahc.linkage_matrix_from_merges(
        np.asarray(jax_merges), np.asarray(jax_heights), len(x))
    np.testing.assert_array_equal(ours[:, [0, 1, 3]], theirs[:, [0, 1, 3]])
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], atol=1e-5)
    for threshold in (0.3, 0.8, 1.2):
        a = ahc.fcluster_by_distance(merges.numpy(), heights.numpy(),
                                     len(x), threshold)
        b = jax_ahc.fcluster_by_distance(np.asarray(jax_merges),
                                         np.asarray(jax_heights), len(x),
                                         threshold)
        np.testing.assert_array_equal(a, b)
        assert same_partition(a, fcluster(ours, threshold,
                                          criterion="distance"))


def test_ahc_on_device_end_to_end():
    x, truth = blobs(n_clusters=2, per=20, seed=1)
    ours = ahc.ahc_on_device(x, threshold=0.5, device="cpu")
    theirs = jax_ahc.ahc_on_device(x, threshold=0.5)
    assert ours.min() == 0
    np.testing.assert_array_equal(ours, theirs)
    assert same_partition(ours, truth)


def test_single_and_pair():
    x = np.array([[0.0, 1.0], [3.0, 5.0]], np.float32)
    merges, heights = ahc.centroid_linkage(torch.from_numpy(x))
    assert merges.tolist() == [[0, 1]]
    np.testing.assert_allclose(heights.numpy(), [5.0])
    empty = ahc.centroid_linkage(torch.zeros((1, 2)))
    assert empty[0].shape == (0, 2) and empty[1].shape == (0,)


@pytest.mark.parametrize("seed", [8, 9])
def test_pipeline_gate_gives_the_host_partition(monkeypatch, seed):
    embeddings, seg = speakers(seed)
    clean, _, num_frames = port_stats(seg)
    params = {"method": "centroid", "threshold": 0.5, "min_cluster_size": 2}
    pipeline = clustering.AgglomerativeClustering()
    pipeline.instantiate(params)
    monkeypatch.setenv("PYANNOTE_TPU_DEVICE_AHC", "0")
    host = pipeline(embeddings, clean, num_frames, max_clusters=4)
    calls = []
    linkage_of = clustering.device_linkage
    monkeypatch.setattr(clustering, "device_linkage",
                        lambda *a, **k: calls.append(1) or linkage_of(*a, **k))
    monkeypatch.setenv("PYANNOTE_TPU_DEVICE_AHC", "1")
    device = pipeline(embeddings, clean, num_frames, max_clusters=4)
    assert calls == [1]
    np.testing.assert_array_equal(device[0], host[0])
    np.testing.assert_allclose(device[2], host[2], atol=1e-12)
