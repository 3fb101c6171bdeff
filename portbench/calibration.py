"""Seeded weights that tell speakers apart, fitted in set-up on speech
with known speakers.

Weights drawn at random compute the work of the published models but say
nothing about who speaks: the segmentation's local speakers would not
follow the voices, and every embedding would fall into one cluster, so
that clustering would do no work. Set-up therefore fits, from the seed,
what a trained model learns last, on labelled recordings of the cell's
mix that it synthesises apart from the pool (a seed stream of their own;
the mix's ``calibration``: ``recordings`` of ``seconds`` each, cut in
chunks every ``hop_seconds``, and ``head_steps`` of Adam):

- the segmentation head (the model's linear layers and classifier, an MLP
  of the published shape) on the BiLSTM's outputs, by Adam from the drawn
  weights, to the powerset classes of the voices' pitch bands: local
  speaker k of a chunk is whoever speaks in pitch band k of the mix
  (``f0_bands``; a recording's speakers each have a band of their own),
  so that a local speaker is one voice, as a trained model's is;
- the embedding's ``seg_1`` projection: a linear discriminant of the
  ResNet's pooled statistics between the voices (each (recording, voice)
  a class, pooled over the frames where the voice speaks alone), its
  directions weighted by how well each separates them;
- the PLDA (VBx's latent space): the x-vector centring and LDA, and the
  two-covariance model of the embeddings so transformed.

Everything runs in float32 (float64 for the eigenproblems) in the plain
reference (``portbench/reference/``), never in the program; the fitted
weights are handed to both, as the drawn ones are.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import pyannet, resnet, segmentation_models
from portbench.reference.numerics import Numerics
from portbench.traffic import generator as gen
from portbench.weights import generator

HEAD_BATCH, HEAD_RATE = 4096, 3e-3
ADAM = (0.9, 0.999, 1e-8)        # beta1, beta2, eps
# the discriminant works in the statistics' leading components: more of
# them separate the fitting set's voices by its noise, and VBx then
# splits a voice of the pool into several clusters
COMPONENTS, RIDGE = 16, 1e-3


def labelled(mix: dict, seed: int, device) -> List[Tuple[torch.Tensor,
                                                        np.ndarray]]:
    """The mix's calibration recordings with their ``turns`` rows."""
    out = []
    plan = mix["calibration"]
    samples = int(plan["seconds"] * mix["sample_rate"])
    for k in range(plan["recordings"]):
        rng = gen.seeded(seed, 4, k)
        rows = gen.turns(samples, rng, mix)
        pcm = gen.synth(samples, rng, mix, (seed * 1000003 + 7919 * k + 1)
                        % 2 ** 63, device, rows=rows)
        out.append((torch.as_tensor(gen.pcm_to_float(pcm), device=device),
                    rows))
    return out


def activity(rows: np.ndarray, centres: np.ndarray, column: np.ndarray,
             classes: int) -> np.ndarray:
    """(C, F, classes) bool: whether a row whose ``column`` value is k
    covers each frame centre (samples, (C, F))."""
    out = np.zeros(centres.shape + (classes,), dtype=bool)
    for row, k in zip(rows, column.astype(np.int64)):
        out[..., k] |= (centres >= row[gen.FIRST]) & (centres < row[gen.END])
    return out


def centres(spec: dict, starts: np.ndarray, window: int) -> np.ndarray:
    """(C, F) sample at the centre of each output frame of the chunks
    at ``starts``."""
    duration, step = segmentation_models.frames(spec)
    rate = spec["hparams"]["sample_rate"]
    frames = np.arange(segmentation_models.num_frames(spec, window))
    return starts[:, None] + ((frames * step + duration / 2) * rate
                              ).astype(np.int64)


def chunked(recordings, spec: dict, hop_seconds: float):
    """Chunks of each recording every ``hop_seconds``: (chunks (N, 1,
    window), [their starts in each recording])."""
    window = _window(spec)
    hop = int(hop_seconds * spec["hparams"]["sample_rate"])
    xs, starts = [], []
    for audio, _ in recordings:
        s = np.arange(0, len(audio) - window + 1, hop, dtype=np.int64)
        xs.append(audio.unfold(0, window, hop)[:len(s)])
        starts.append(s)
    return torch.cat(xs)[:, None].contiguous(), starts


def powerset_targets(bands: np.ndarray, mapping: torch.Tensor
                     ) -> torch.Tensor:
    """(..., bands) activity -> powerset class per frame."""
    a = torch.as_tensor(bands, dtype=torch.float32)
    m = mapping.to(torch.float32)
    return (a @ m.t() * 2 - m.sum(dim=1)).argmax(dim=-1)


def fit_head(p: Dict[str, torch.Tensor], hp: dict, features: torch.Tensor,
             targets: torch.Tensor, seed: int, steps: int
             ) -> Dict[str, float]:
    """The linear layers and the classifier in ``p``, fitted by Adam to
    ``targets`` from ``features`` (frames, 2H), minibatches drawn from the
    seed; returns the fit's accuracy and loss on its frames. Adam is
    written out: ``torch.optim``'s first step loads TorchDynamo, seconds
    of set-up that no later step needs."""
    names = [f"{n}.{kind}" for n in
             [f"linear.{i}" for i in range(hp["linear"]["num_layers"])]
             + ["classifier"] for kind in ("weight", "bias")]
    state = {n: p[n].detach().clone().requires_grad_(True) for n in names}
    params = list(state.values())
    moments = [(torch.zeros_like(q), torch.zeros_like(q)) for q in params]
    g = generator(seed, 5, features.device)
    for step in range(1, steps + 1):
        i = torch.randint(0, len(features), (HEAD_BATCH,), generator=g,
                          device=features.device)
        with torch.enable_grad():
            loss = F.cross_entropy(pyannet.head(features[i], state, hp,
                                                logits=True), targets[i])
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for q, grad, (m, v) in zip(params, grads, moments):
                m.lerp_(grad, 1 - ADAM[0])
                v.lerp_(grad * grad, 1 - ADAM[1])
                q.addcdiv_(m, (v / (1 - ADAM[1] ** step)).sqrt_().add_(
                    ADAM[2]), value=-HEAD_RATE / (1 - ADAM[0] ** step))
    with torch.no_grad():
        for name, value in state.items():
            p[name] = value.detach().clone()
        logits = pyannet.head(features, p, hp, logits=True)
        return {"accuracy": float((logits.argmax(-1) == targets)
                                  .float().mean()),
                "loss": float(F.cross_entropy(logits, targets))}


def segmentation(p: Dict[str, torch.Tensor], spec: dict, mix: dict,
                 recordings, seed: int):
    """Fit ``p``'s head on the labelled recordings (see the module).
    Returns (the fit's numbers, the chunks' starts, their (N, F, S) hard
    segmentation as the fitted model decodes it)."""
    plan = mix["calibration"]
    window = _window(spec)
    chunks, starts = chunked(recordings, spec, plan["hop_seconds"])
    bands = np.concatenate([
        activity(rows, centres(spec, s, window), rows[:, gen.BAND],
                 len(mix["f0_bands"])) for (_, rows), s in zip(recordings,
                                                              starts)])
    hp = segmentation_models.hparams(spec)
    mapping = pyannet.powerset_mapping(
        len(spec["specifications"]["classes"]),
        spec["specifications"]["powerset_max_classes"])
    with torch.inference_mode():
        feats = segmentation_models.forward(spec, p, chunks,
                                            Numerics("float32"),
                                            features=True)
    shape = feats.shape
    feats = feats.flatten(0, 1).clone()
    targets = powerset_targets(bands, mapping).flatten().to(feats.device)
    fit = fit_head(p, hp, feats, targets, seed, plan["head_steps"])
    fit["silent"] = float((targets == 0).float().mean())
    with torch.inference_mode():
        decoded = pyannet.to_multilabel(
            pyannet.head(feats, p, hp).view(*shape[:2], -1), mapping)
    return fit, starts, decoded.cpu().numpy()


def _window(spec: dict) -> int:
    return int(round(spec["specifications"]["duration"]
                     * spec["hparams"]["sample_rate"]))


def _discriminant(x: torch.Tensor, labels: np.ndarray, ridge: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(directions (D, k), between-to-within ratios (k,)), largest
    first, of the classes ``labels`` of rows ``x`` (float64)."""
    labels = torch.as_tensor(labels, device=x.device)
    classes, inverse = torch.unique(labels, return_inverse=True)
    counts = torch.bincount(inverse).to(x.dtype)
    means = torch.zeros(len(classes), x.shape[1], dtype=x.dtype,
                        device=x.device).index_add_(0, inverse, x) \
        / counts[:, None]
    centre = x.mean(dim=0)
    within = (x - means[inverse]).T @ (x - means[inverse]) / len(x)
    spread = (means - centre) * counts[:, None].sqrt()
    between = spread.T @ spread / len(x)
    within = within + ridge * within.diagonal().mean() * torch.eye(
        len(within), dtype=x.dtype, device=x.device)
    chol = torch.linalg.cholesky(within)
    inner = torch.linalg.solve_triangular(
        chol, torch.linalg.solve_triangular(chol, between, upper=False).T,
        upper=False)
    values, vectors = torch.linalg.eigh((inner + inner.T) / 2)
    directions = torch.linalg.solve_triangular(chol.T, vectors, upper=True)
    order = torch.argsort(values, descending=True)
    return directions[:, order], values[order].clamp(min=0)


def speaker_masks(spec: dict, recordings, starts, decoded) -> list:
    """Per recording: (chunk starts, (C, S, F) masks of the frames where
    each of the model's local speakers speaks alone in the ``decoded``
    hard segmentation, (C, S) the voice each speaks most)."""
    window = _window(spec)
    out, first = [], 0
    for k, (s, (_, rows)) in enumerate(zip(starts, recordings)):
        binarized = decoded[first:first + len(s)]
        first += len(s)
        voices = int(rows[:, gen.VOICE].max()) + 1
        truth = activity(rows, centres(spec, s, window), rows[:, gen.VOICE],
                         voices)
        alone = binarized * (binarized.sum(axis=-1, keepdims=True) == 1)
        overlap = np.einsum("cfs,cfv->csv", alone, truth.astype(np.float64))
        out.append((s, alone.transpose(0, 2, 1), k * 16 + overlap.argmax(-1)))
    return out


def embedding(p: Dict[str, torch.Tensor], hp: dict, spec: dict,
              masks: list, recordings, plda_dims: Tuple[int, int] = None
              ) -> Dict[str, np.ndarray]:
    """Fit ``p``'s ``seg_1`` (and, with ``plda_dims`` = (dim, lda_dim),
    return a PLDA) on the labelled recordings, pooled under ``masks``
    (``speaker_masks``) (see the module)."""
    window = _window(spec)
    stats, labels = [], []
    num = Numerics("float32")
    for (audio, _), (starts, mask, keys) in zip(recordings, masks):
        m = torch.as_tensor(mask, dtype=torch.float32, device=audio.device)
        with torch.inference_mode():
            pooled = resnet.embeddings(audio, starts, window, m, p,
                                       dict(hp, real_samples=len(audio)),
                                       num, project=False)
        enough = mask.sum(axis=-1) >= 0.2 * mask.shape[-1]
        stats.append(pooled[torch.as_tensor(enough, device=audio.device)])
        labels.append(keys[enough])
    x = torch.cat(stats).double()
    labels = np.concatenate(labels)
    centre = x.mean(dim=0)
    # the discriminant in the span of the data's leading components (from
    # the eigenvectors of the rows' Gram matrix: rows are far fewer than
    # the statistics' dimensions)
    values, vectors = torch.linalg.eigh((x - centre) @ (x - centre).T)
    top = torch.argsort(values, descending=True)[:COMPONENTS]
    basis = (x - centre).T @ (vectors[:, top] / values[top].clamp(
        min=1e-30).sqrt())
    directions, ratios = _discriminant((x - centre) @ basis, labels, RIDGE)
    dim = hp["embed_dim"]
    weight = torch.zeros(dim, x.shape[1], dtype=torch.float64,
                         device=x.device)
    k = min(dim, directions.shape[1])
    scale = (ratios[:k] / (1 + ratios[:k])).sqrt()
    weight[:k] = (basis @ (directions[:, :k] * scale)).T
    p["resnet.seg_1.weight"] = weight.float()
    p["resnet.seg_1.bias"] = (-(weight @ centre)).float()
    if plda_dims is None:
        return {}
    return plda((x - centre) @ weight.T, labels, *plda_dims)


def plda(emb: torch.Tensor, labels: np.ndarray, dim: int, lda_dim: int
         ) -> Dict[str, np.ndarray]:
    """A PLDA for VBx from embeddings ``emb`` of known ``labels``: the
    x-vector centring (mean1, then length norm), the first ``lda_dim``
    dimensions, their centring (mean2, then length norm) and the
    two-covariance model (mu, tr, psi: within-class covariance
    inv(tr' tr), between-class inv((tr' / psi) tr))."""
    def unit(v):
        return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    mean1 = emb.mean(dim=0)
    h = math.sqrt(dim) * unit(emb - mean1)
    # the embedding's dimensions are a discriminant's, strongest first
    lda = torch.eye(dim, lda_dim, dtype=h.dtype, device=h.device)
    mean2 = (h @ lda).mean(dim=0)
    h2 = math.sqrt(lda_dim) * unit(h @ lda - mean2)
    mu = h2.mean(dim=0)
    vectors, psi = _discriminant(h2 - mu, labels, RIDGE)
    arrays = {"mean1": mean1, "mean2": mean2, "lda": lda, "mu": mu,
              "tr": vectors.T, "psi": psi.clamp(min=1e-4)}
    return {k: v.double().cpu().numpy() for k, v in arrays.items()}


def fit(ctx, weights: Dict[str, Dict[str, torch.Tensor]],
        plda_dims: Tuple[int, int] = None) -> Dict[str, np.ndarray]:
    """Fit the drawn ``weights`` in place (see the module) on labelled
    recordings of the cell's mix; returns the PLDA with ``plda_dims``."""
    spec = ctx.config["segmentation"]
    mix = ctx.traffic.mix
    start = time.perf_counter()
    recordings = labelled(mix, ctx.seed, ctx.device)
    head, starts, decoded = segmentation(weights["segmentation"], spec, mix,
                                         recordings, ctx.seed)
    ctx.log(f"segmentation head fitted in {time.perf_counter() - start:.3f}"
            " s: " + ", ".join(f"{k} {v:.4f}" for k, v in head.items()))
    start = time.perf_counter()
    out = embedding(weights["embedding"], ctx.config["embedding"]["hparams"],
                    spec, speaker_masks(spec, recordings, starts, decoded),
                    recordings, plda_dims)
    ctx.log(f"seg_1{' and the PLDA' if out else ''} fitted in "
            f"{time.perf_counter() - start:.3f} s"
            + (": between-to-within ratios " + ", ".join(
                f"{v:.2f}" for v in out["psi"][:4]) if out else ""))
    return out
