"""PLDA transform for VBx clustering.

Counterpart of pyannote_audio_tpu/core/plda.py: loads
``xvec_transform.npz`` (mean1, mean2, lda) and ``plda.npz`` (mu, tr,
psi), builds the centering / whitening / LDA preprocessor and the PLDA
latent projection through a one-time generalized eigendecomposition of
the between- and within-class covariances. Host numpy in float64: it runs
once at load, and the per-call transform is two small matmuls that the
VBx EM consumes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
from scipy.linalg import eigh


def _unit_norm(x: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.where(norm > 0, norm, 1.0)


class PLDA:
    """x-vector -> PLDA latent space transform."""

    def __init__(self, mean1: np.ndarray, mean2: np.ndarray,
                 lda: np.ndarray, plda_mu: np.ndarray,
                 plda_tr: np.ndarray, plda_psi: np.ndarray):
        self.mean1 = mean1
        self.mean2 = mean2
        self.lda = lda
        self.plda_mu = plda_mu

        # between/within-class covariances in the transform basis, then a
        # generalized eigenproblem yields the simultaneous diagonalizer:
        # identity within-class, diagonal (psi) across-class covariance
        within = np.linalg.inv(plda_tr.T @ plda_tr)
        between = np.linalg.inv((plda_tr.T / plda_psi) @ plda_tr)
        eigvals, eigvecs = eigh(between, within)
        self._psi = eigvals[::-1]
        self._projection = eigvecs.T[::-1]
        self.lda_dim = lda.shape[1]

    @property
    def phi(self) -> np.ndarray:
        """Across-class covariance diagonal in the latent space."""
        return self._psi[:self.lda_dim]

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        """Centering + length-norm + LDA + re-centering + length-norm."""
        h = np.sqrt(self.lda.shape[0]) * _unit_norm(x - self.mean1)
        h = h @ self.lda - self.mean2
        return np.sqrt(self.lda.shape[1]) * _unit_norm(h)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Full transform: preprocess then project to the latent space."""
        h = self.preprocess(x)
        return ((h - self.plda_mu) @ self._projection.T)[:, :self.lda_dim]

    @classmethod
    def from_pretrained(cls, checkpoint: Union[str, Path],
                        subfolder: str = "", revision=None, token=None,
                        cache_dir=None) -> "PLDA":
        """Load from a local directory (``/subfolder``) holding
        ``xvec_transform.npz`` and ``plda.npz``, or from a hub id hosting
        those two files (``utils/hf_hub.py``)."""
        if checkpoint is None:
            raise ValueError(
                "PLDA.from_pretrained requires a directory or hub id "
                "holding xvec_transform.npz and plda.npz")
        from ..utils.hf_hub import hub_asset
        hub = dict(subfolder=subfolder or None, revision=revision,
                   token=token, cache_dir=cache_dir)
        xvec = hub_asset(checkpoint, "xvec_transform.npz", **hub)
        if xvec is not None:
            hub_asset(checkpoint, "plda.npz", **hub)
            path = xvec.parent
        else:
            path = Path(checkpoint) / subfolder if subfolder \
                else Path(checkpoint)
        if not (path / "xvec_transform.npz").is_file() or \
                not (path / "plda.npz").is_file():
            raise ValueError(
                f"{path} holds no xvec_transform.npz + plda.npz, locally "
                f"or as a hub id")
        x = np.load(path / "xvec_transform.npz")
        p = np.load(path / "plda.npz")
        return cls(mean1=x["mean1"], mean2=x["mean2"], lda=x["lda"],
                   plda_mu=p["mu"], plda_tr=p["tr"], plda_psi=p["psi"])
