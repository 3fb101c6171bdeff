"""The set-up fit (``portbench/calibration.py``) and the end-to-end
comparison's label matching, against hand arithmetic at small sizes."""

import numpy as np
import pytest
import torch

from portbench import calibration
from portbench.reference import pyannet
from portbench.reference.check import matched_disagreement


def test_powerset_targets_follow_the_mapping():
    mapping = pyannet.powerset_mapping(3, 2)
    bands = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 1, 0],
                      [0, 1, 1], [1, 0, 1]], dtype=bool)
    assert calibration.powerset_targets(bands, mapping).tolist() == \
        [0, 1, 3, 4, 6, 5]


def test_matched_disagreement_ignores_label_names():
    ours = np.array([0, 0, 1, 1, 2, 2])
    assert matched_disagreement(ours, np.array([5, 5, 3, 3, 9, 9])) == 0.0
    assert matched_disagreement(ours, np.array([5, 5, 3, 3, 9, 3])) == \
        pytest.approx(1 / 6)
    assert matched_disagreement(ours, np.zeros(6, dtype=int)) == \
        pytest.approx(4 / 6)


def _labelled(classes=12, per=30, dim=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    centres = torch.randn(classes, dim, generator=g, dtype=torch.float64)
    labels = np.repeat(np.arange(classes), per)
    x = centres[labels] * 3 + torch.randn(len(labels), dim, generator=g,
                                          dtype=torch.float64)
    return x, labels


def test_discriminant_whitens_within_and_diagonalises_between():
    x, labels = _labelled()
    directions, ratios = calibration._discriminant(x - x.mean(0), labels,
                                                   ridge=0.0)
    means = torch.stack([x[labels == k].mean(0) for k in range(12)])
    within = (x - means[labels]).T @ (x - means[labels]) / len(x)
    between = (means - x.mean(0)).T @ (means - x.mean(0)) * 30 / len(x)
    assert torch.allclose(directions.T @ within @ directions,
                          torch.eye(24, dtype=torch.float64), atol=1e-8)
    assert torch.allclose(directions.T @ between @ directions,
                          torch.diag(ratios), atol=1e-8)
    assert torch.all(ratios[:-1] >= ratios[1:])


def test_plda_is_the_two_covariance_model_of_its_embeddings():
    x, labels = _labelled(dim=32)
    arrays = calibration.plda(x, labels, dim=32, lda_dim=16)
    tr, psi = arrays["tr"], arrays["psi"]
    within = np.linalg.inv(tr.T @ tr)
    between = np.linalg.inv((tr.T / psi) @ tr)
    assert np.allclose(tr @ within @ tr.T, np.eye(16), atol=1e-6)
    assert np.allclose(tr @ between @ tr.T, np.diag(psi), atol=1e-6)
    assert arrays["lda"].shape == (32, 16) and np.all(psi > 0)


def test_a_moved_pair_counts_and_a_tie_does_not():
    from portbench.reference.clustering import moved
    soft = np.array([[[0.9, 0.1], [0.2, 0.8]],
                     [[0.5, 0.5], [0.1, 0.7]]])
    active = np.ones((2, 2), dtype=bool)
    theirs = np.array([[0, 1], [0, 1]])
    assert moved(theirs, theirs, soft, active, per_chunk=True) == 0
    # chunk 1's first pair ties: either cluster is as good
    ours = np.array([[0, 1], [1, 1]])
    assert moved(ours, theirs, soft, active, per_chunk=False) == 0
    # chunk 0 swapped: its sum falls by 1.4, both pairs count
    ours = np.array([[1, 0], [0, 1]])
    assert moved(ours, theirs, soft, active, per_chunk=True) == 2
    # a label the reference does not have counts
    assert moved(np.array([[0, 2], [0, 1]]), theirs, soft, active,
                 per_chunk=False) == 1
