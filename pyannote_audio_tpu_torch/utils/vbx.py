"""VBx: variational Bayes x-vector clustering (GMM variant, no HMM).

Counterpart of pyannote_audio_tpu/utils/vbx.py, an implementation of the
published VBx algorithm (Landini, Profant, Diez, Burget: "Bayesian HMM
clustering of x-vector sequences (VBx) in speaker diarization", Computer
Speech & Language 2022) as the reference's VBxClustering runs it.

Model: latent speaker vectors with zero mean, diagonal across-class
covariance ``phi`` and identity within-class covariance. The EM loop
alternates speaker-model posteriors (precision ``inv_l``, mean ``mu``) with
frame responsibilities ``gamma``, scaled by Fa (statistics scale) and Fb
(speaker-count regularizer); redundant speakers' priors decay to ~0.

``vbx_em`` runs on the host in float64 with early stopping, the default.
``vbx_em_torch`` (the JAX package's ``vbx_em_jax``) runs a fixed number of
iterations in float32 on a torch device; ``cluster_vbx`` takes it where
the opt-in gate PYANNOTE_TPU_DEVICE_VBX is "1".
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy.special import logsumexp, softmax

from .runtime import device_flag, exact_float32


def vbx_em(
    x: np.ndarray,                 # (T, D) latent-space features
    phi: np.ndarray,               # (D,) across-class covariance diagonal
    fa: float = 1.0,
    fb: float = 1.0,
    gamma: Optional[np.ndarray] = None,   # (T, S) initial responsibilities
    max_speakers: Optional[int] = None,
    max_iters: int = 10,
    epsilon: float = 1e-4,
    pi: Optional[np.ndarray] = None,      # (S,) initial speaker priors
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Run the VBx EM loop.

    ``pi`` seeds the speaker priors used by the FIRST responsibility
    update (reference vbx.py:119: ``log(pi)`` with the caller's priors);
    None means uniform. Returns (gamma (T, S), pi (S,), elbo_trace).
    """
    t_frames, dim = x.shape
    if gamma is None:
        if max_speakers is None:
            raise ValueError("provide gamma or max_speakers")
        rng = np.random.default_rng(0)
        gamma = rng.gamma(1.0, size=(t_frames, max_speakers))
        gamma = gamma / gamma.sum(axis=1, keepdims=True)
    num_speakers = gamma.shape[1]
    if pi is None:
        pi = np.full(num_speakers, 1.0 / num_speakers)
    else:
        pi = np.asarray(pi, dtype=np.float64)
        if pi.shape != (num_speakers,):
            raise ValueError(
                f"pi has {pi.shape} priors for {num_speakers} speakers")

    # constant per-frame term of the log-likelihood
    const = -0.5 * (np.sum(x ** 2, axis=1, keepdims=True)
                    + dim * np.log(2 * np.pi))
    rho = x * np.sqrt(phi)          # projected first-order stats

    trace = []
    prev_elbo = -np.inf
    for _ in range(max_iters):
        # speaker-model update: posterior precision and mean per speaker
        occupancy = gamma.sum(axis=0)                       # (S,)
        inv_l = 1.0 / (1.0 + (fa / fb) * occupancy[:, None] * phi)  # (S, D)
        mu = (fa / fb) * inv_l * (gamma.T @ rho)            # (S, D)

        # per-frame per-speaker log-likelihood
        log_p = fa * (rho @ mu.T
                      - 0.5 * (inv_l + mu ** 2) @ phi
                      + const)

        log_joint = log_p + np.log(pi + 1e-8)
        log_marginal = logsumexp(log_joint, axis=-1)
        gamma = np.exp(log_joint - log_marginal[:, None])
        pi = gamma.sum(axis=0)
        pi = pi / pi.sum()

        elbo = log_marginal.sum() + fb * 0.5 * np.sum(
            np.log(inv_l) - inv_l - mu ** 2 + 1.0)
        trace.append(elbo)
        if elbo - prev_elbo < epsilon and len(trace) > 1:
            break
        prev_elbo = elbo
    return gamma, pi, trace


def vbx_em_torch(x, phi, fa: float = 1.0, fb: float = 1.0, gamma=None,
                 max_iters: int = 10, max_speakers: Optional[int] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cpu"):
    """VBx EM in float32 on ``device`` for exactly ``max_iters`` iterations.

    The same updates as :func:`vbx_em` with the early-stopping test
    replaced by a fixed count (extra iterations only tighten the ELBO).
    ``gamma=None`` needs ``max_speakers`` and draws the random initial
    responsibilities on the host, as :func:`vbx_em` does. Returns
    (gamma (T, S), pi (S,), elbos (max_iters,)) as tensors on ``device``.
    """
    if gamma is None:
        if max_speakers is None:
            raise ValueError("provide gamma or max_speakers")
        rng = np.random.default_rng(seed)
        gamma = rng.gamma(1.0, size=(np.asarray(x).shape[0], max_speakers))
        gamma = gamma / gamma.sum(axis=1, keepdims=True)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)
    x, phi, gamma = on_device(x), on_device(phi), on_device(gamma)
    _, dim = x.shape
    const = -0.5 * ((x ** 2).sum(dim=1, keepdim=True)
                    + dim * math.log(2 * math.pi))
    rho = x * torch.sqrt(phi)
    num_speakers = gamma.shape[1]
    pi = torch.full((num_speakers,), 1.0 / num_speakers, device=x.device)
    elbos = []
    with exact_float32():
        for _ in range(max_iters):
            occupancy = gamma.sum(dim=0)
            inv_l = 1.0 / (1.0 + (fa / fb) * occupancy[:, None] * phi)
            mu = (fa / fb) * inv_l * (gamma.T @ rho)
            log_p = fa * (rho @ mu.T - 0.5 * (inv_l + mu ** 2) @ phi
                          + const)
            log_joint = log_p + torch.log(pi + 1e-8)
            log_marginal = torch.logsumexp(log_joint, dim=-1)
            gamma = torch.exp(log_joint - log_marginal[:, None])
            pi = gamma.sum(dim=0)
            pi = pi / pi.sum()
            elbos.append(log_marginal.sum() + fb * 0.5 * torch.sum(
                torch.log(inv_l) - inv_l - mu ** 2 + 1.0))
    return gamma, pi, torch.stack(elbos) if elbos else x.new_zeros(0)


def cluster_vbx(
    init_clusters: np.ndarray,     # (T,) integer AHC initialization
    features: np.ndarray,          # (T, D) PLDA latent features
    phi: np.ndarray,
    fa: float,
    fb: float,
    max_iters: int = 20,
    init_smoothing: float = 7.0,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """AHC-initialized VBx; returns (gamma (T, S), pi (S,)): the host EM,
    or ``vbx_em_torch`` on ``device`` where PYANNOTE_TPU_DEVICE_VBX is
    "1"."""
    num_init = int(init_clusters.max()) + 1
    one_hot = np.zeros((len(init_clusters), num_init))
    one_hot[np.arange(len(init_clusters)), init_clusters.astype(int)] = 1.0
    gamma0 = one_hot if init_smoothing < 0 else \
        softmax(one_hot * init_smoothing, axis=1)
    if device_flag("PYANNOTE_TPU_DEVICE_VBX", device,
                   accelerator_default=False):
        gamma, pi, _ = vbx_em_torch(features, phi, fa=fa, fb=fb,
                                    gamma=gamma0, max_iters=max_iters,
                                    device=device)
        return gamma.cpu().numpy(), pi.cpu().numpy()
    gamma, pi, _ = vbx_em(features, phi, fa=fa, fb=fb, gamma=gamma0,
                          max_iters=max_iters)
    return gamma, pi


# -- the reference's signatures ---------------------------------------------

def l2_norm(vec_or_matrix: np.ndarray) -> np.ndarray:
    """L2-normalize one vector or each row of a matrix.

    Parity: l2_norm (reference utils/vbx.py:158-177)."""
    vec_or_matrix = np.asarray(vec_or_matrix)
    if vec_or_matrix.ndim == 1:
        return vec_or_matrix / np.linalg.norm(vec_or_matrix)
    if vec_or_matrix.ndim == 2:
        return vec_or_matrix / np.linalg.norm(vec_or_matrix, axis=1,
                                              keepdims=True)
    raise ValueError(
        f"the input must be 1D or 2D, got shape {vec_or_matrix.shape}")


def VBx(X, Phi, Fa=1.0, Fb=1.0, pi=10, gamma=None, maxIters=10,
        epsilon=1e-4, alphaQInit=1.0, ref=None, plot=False,
        return_model=False, alpha=None, invL=None):
    """Reference-signature entry point over :func:`vbx_em`.

    Parity: VBx (reference utils/vbx.py:27-137): ``pi`` as an int caps
    the speaker count; a VECTOR is used as the actual speaker-prior
    initialization (reference :87-88,119 — not just its length);
    returns (gamma, pi, Li) with Li the ELBO trace as
    single-element rows, plus (alpha, invL) — the final speaker-mean /
    posterior-precision model — when ``return_model`` is set. ``ref``,
    ``plot``, ``alphaQInit`` and warm-start ``alpha``/``invL`` are
    accepted for signature parity; the EM recomputes the model from
    ``gamma`` in its first iteration anyway.
    """
    x = np.asarray(X, dtype=np.float64)
    phi = np.asarray(Phi, dtype=np.float64)
    if np.ndim(pi) == 0:
        max_speakers, pi_init = int(pi), None
    else:
        pi_init = np.asarray(pi, dtype=np.float64)
        max_speakers = len(pi_init)
    gamma, pi_out, trace = vbx_em(
        x, phi, fa=Fa, fb=Fb, gamma=gamma,
        max_speakers=max_speakers, max_iters=maxIters, epsilon=epsilon,
        pi=pi_init)
    out = (gamma, pi_out, [[float(e)] for e in trace])
    if not return_model:
        return out
    occupancy = gamma.sum(axis=0)
    inv_l = 1.0 / (1.0 + (Fa / Fb) * occupancy[:, None] * phi)
    mu = (Fa / Fb) * inv_l * (gamma.T @ (x * np.sqrt(phi)))
    return out + (mu, inv_l)


def vbx_setup(transform_npz, plda_npz):
    """Load the x-vector -> PLDA-space transformation pipeline.

    Parity: vbx_setup (reference utils/vbx.py:181-218): returns
    (xvec_tf, plda_tf, plda_psi) where ``xvec_tf`` centers/whitens/LDA-
    projects raw x-vectors, ``plda_tf`` maps them into the PLDA latent
    space (optionally truncated), and ``plda_psi`` holds the reordered
    between-class eigenvalues used as the VBx across-class covariance.
    """
    from scipy.linalg import eigh

    x = np.load(transform_npz)
    mean1, mean2, lda = x["mean1"], x["mean2"], x["lda"]

    p = np.load(plda_npz)
    plda_mu, plda_tr, plda_psi = p["mu"], p["tr"], p["psi"]

    # within/between-class covariances from the PLDA transform, then the
    # generalized eigenproblem yields the diagonalizing rotation
    within = np.linalg.inv(plda_tr.T.dot(plda_tr))
    between = np.linalg.inv((plda_tr.T / plda_psi).dot(plda_tr))
    acvar, wccn = eigh(between, within)
    plda_psi = acvar[::-1]
    plda_tr = wccn.T[::-1]

    def xvec_tf(x0):
        centered = np.sqrt(lda.shape[0]) * l2_norm(x0 - mean1)
        return np.sqrt(lda.shape[1]) * l2_norm(
            lda.T.dot(centered.T).T - mean2)

    def plda_tf(x0, lda_dim=lda.shape[1]):
        return (x0 - plda_mu).dot(plda_tr.T)[:, :lda_dim]

    return xvec_tf, plda_tf, plda_psi
