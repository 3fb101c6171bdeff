"""Run the PyTorch/CUDA port's main paths on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py tf32x3     # phases 1, 2 and 3c only

Phases, each fatal on failure:
  1. environment: torch and CUDA versions, the card's name and power
     limit, and torch's TF32 flags, left at their defaults (the port
     pins float32 at its own float32 sites);
  2. build every kernel of the path from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, at phase 10's (DPRNN's intra- and inter-chunk
     BiLSTMs at a full batch and the tail, SSeRiouSS's at each batch
     size) and at ragged ones, in each LSTM precision ("default", "high",
     "highest"), with kernel and plain times, the bound of each mode, and
     cuDNN's torch.nn.LSTM over the same layer beside the port's
     projection + kernel (a yardstick only), phase 10's shapes each
     timed on its own; the backward kernel (one launch: the recompute at
     "highest" into a workspace, then the reverse walk; one product per
     direction for W_hh) against the plain backward at every training
     shape (589 x 32 / 7 / 16, the DPRNN's of (w) and (z) and their
     tails) and at the edges of its geometry, and LSTMRecurrence (the
     kernel forward and the backward kernel) against the all-plain
     autograd at the training shapes, with the backward's parts
     (recompute, walk, W_hh product) timed apart beside cuDNN's layer
     backward at every training shape, and the forward, the backward per
     layer (its bounds on the tensor cores' and the CUDA cores' route,
     the workspace's peak bytes), the plain backward, the plain
     recurrence's autograd (the backward before the kernel) and cuDNN's
     layer backward and forward + backward timed at 589 x 32 / 16 and
     the DPRNN's intra-chunk shapes; both
     kernels' streamed route above H = 256 (W_hh through shared memory,
     resident or streamed by bulk copies): the forward against its plain
     version (within 1e-5 in "highest", its three TF32 passes) at 589 x
     32 and 589 x 256 for H = 257, 384 and 512 and at phase 4's 589 x 171,
     H = 512 in each precision and at 589 x 8, H = 1024 in "default", and
     at the edges of its geometry (B astride every step of rows, cluster,
     row tiles a warp, resident / streamed and waves, reaching every
     instantiation), the backward against the plain backward at 589 x 32
     for H = 384 and 512 and at its edges, and LSTMRecurrence against the
     all-plain autograd at H = 512, each timed beside its bound, its plain
     version and cuDNN's float32 layer (in rounds between the port's);
     3c. the 3xTF32 GEMM (``ops/tf32x3_gemm.py``) at the float32 WavLM-base
     trunk's shapes (its linears at 32 x 499 rows, convs 1-6 over 32
     ten-second chunks), each against a float64 product (at most 4x the
     library's float32 error) and timed beside its bound (3 x 2MNK at
     495 TFLOP/s), its plain version and the library's float32 call
     under ``exact_float32`` (cuBLAS, cuDNN), then ``.launches`` and
     ``.torch_calls`` over one SSeRiouSS file (every product on the
     kernel, none on torch);
  4. the exact path (the accelerator gates PYANNOTE_TPU_SEG_BF16,
     _SHARED_SINC and _SHARED_TRUNK forced to "0", a float32 trunk,
     PYANNOTE_TPU_LSTM_PRECISION=highest):
     SpeakerDiarization with full-width PyanNet and WeSpeaker ResNet34
     (seeded random weights) at bench.py's settings, held against the
     same pipeline on the CPU on a 30 s file, then timed with its stages
     on a synthetic PCM16 WAV file of 3 minutes; then the same with a
     PyanNet whose BiLSTM has H = 512 (the kernels' streamed route, its
     head calibrated to mark speech), held against the CPU on the
     3-minute file, its forward launches counted;
  5. the accelerator path at its defaults on the card (bf16 SincNet and
     trunk, the shared whole-file sinc front-end, fbank and trunk, the
     conv-fbank, the LSTM's bf16 products): each shared module held
     against its exact counterpart at full width, the "default" LSTM
     precision against "highest" on PyanNet's log-probs (check (f)), and
     the fbank's spectra (composed conv, DFT matmul, cuFFT) timed against
     each other; then files of 10 and 3 minutes through ``apply_batch``,
     with the LSTM kernel's launch count and the path counters proving
     which path ran and the peak device memory, timed through
     ``apply_batch`` and file by file, and with stage timers;
  6. serving: (g) the 10-minute file in forced 3-minute slices against
     whole-file buffers; (h) a 150-minute file under the automatic slice
     plan (3 slices) against the same file forced whole, with both peaks
     and walls; (i) ``apply_batch`` on bench.py's 60/20/10-minute mix
     plus the 10 and 3 minute files against ``apply`` file by file, with
     the reconstruction on one stream and on a second one, walls, peaks,
     host time in ``_stage`` and ``_finalize``, path counters and LSTM
     launches; (j) ``_stage`` of one file, whole and in slices, under
     ``torch.cuda.set_sync_debug_mode("error")``;
  7. (k) the exact path under torch's default TF32 flags, after
     ``torch.set_float32_matmul_precision("high")``, held to the CPU
     (and, as a measurement, the same with the port's pinning lifted);
     (l) the community-1 shape: a snapshot (full-width PyanNet and
     ResNet34 reference checkpoints written by
     ``utils.convert.write_reference_checkpoint``, a seeded synthetic
     PLDA 256 -> 128) loaded by ``Pipeline.from_pretrained`` from a
     config dict with VBx clustering, moved with ``.to("cuda")``; 10 + 3
     min through ``apply_batch`` and file by file, the serving list
     through ``apply_batch`` with VBx's host time beside AHC's, the
     KMeans fallback (``num_speakers=2``), label mapping onto a synthetic
     annotation with ``get_metric()``, and the device VBx and KMeans
     (PYANNOTE_TPU_DEVICE_VBX / _KMEANS) against their host versions;
  8. the slice of VAD, multilabel and non-powerset diarization, audio at
     any rate and device AHC: (m) VoiceActivityDetection from a config
     dict over (l)'s snapshot, card against CPU on 30 s and 10 + 3 min
     with its LSTM launches; (n) a multi-label PyanNet (sigmoid head, 3
     speakers, 5 s chunks, 4 BiLSTM layers) through
     MultiLabelSegmentation (10 min) and non-powerset SpeakerDiarization
     (10 + 3 min), card against CPU on 30 s on the exact path; (o) a
     44.1 kHz stereo 24-bit and a 48 kHz float32 WAV through
     SpeakerDiarization against the same audio pre-resampled to 16 kHz
     PCM16, and ``_predecode_batch`` against one-by-one decode; (p)
     PYANNOTE_TPU_DEVICE_AHC=1 against host scipy on the serving list;
     (q) the device hysteresis and aggregation against the CPU at the
     VAD's serving-list sizes;
  9. embedders: (r) WeSpeaker ResNet34 and ResNet293 from .onnx files of
     initializers, ECAPA-TDNN from a SpeechBrain snapshot directory,
     TitaNet-large from a NeMo state dict, XVectorSincNet and XVectorMFCC
     from reference checkpoints, each at its published width with seeded
     weights, on one batch of 32 five-second chunks, unmasked and with
     masks that leave some rows too short (NaN), card against CPU (on 4
     of the 32 rows for ResNet293), with its time per batch; (s) SpeakerEmbedding from a config dict over
     (l)'s PyanNet and the ECAPA snapshot on three 1-minute files (card
     against CPU on the exact path, LSTM launches), then
     verification_trials_eer over seeded trials; (t) SpeakerDiarization
     with the XVectorSincNet checkpoint on 10 + 3 min through
     ``apply_batch`` (the per-chunk path, LSTM launches) and card against
     CPU on the 3-minute file by (g)'s near-tie rule; (u) with a
     full-width ResNet293 (bf16 trunk) on the 3-minute file: the shared
     trunk, its panels against one unpanelled pass, peak memory;
 10. SSeRiouSS and speech separation: (v) SSeRiouSS at its defaults
     (WAVLM_BASE trunk, seeded), one batch of 32 ten-second chunks card
     against CPU (the seeded model's log-probs under "highest"; then,
     its BiLSTM and linears scaled and its head calibrated so that it
     marks speech, every powerset flip a near tie in both precisions),
     and SpeakerDiarization with ResNet34 on 10 + 3 min through
     ``apply_batch`` (LSTM launches exact, wall, peak); (w) ToTaToNet at
     its defaults with the WavLM-large branch, one batch of 32
     five-second chunks card against CPU in "highest" and "default"
     (diarization and sources), ``Inference``'s (diarization, sources)
     tuple, SpeechSeparation on 3 min (launches, wall, peak, sources)
     and on 15 s against the CPU's run by the near-tie rule (its head
     calibrated);
 11. training (x): one step of full-width PyanNet on 4 ten-second chunks
     card against CPU on the exact path (loss, every gradient, SincNet's
     also in float64, 3 Adam steps), the card's kernel path against its
     all-plain path, then Trainer.fit under SpeakerDiarization at the
     reference's defaults on a synthetic protocol written from a seed (2
     epochs of 5 steps of 32, validation, checkpoints): LSTM forward and
     backward launches (per step from the fit's counts), the step's time
     split, peak
     memory, losses, der/val, the best checkpoint reloaded through
     Model.from_pretrained and resume_from epoch 0 (parameters, their
     epoch-1 updates, Adam's step counts and moments, the epoch-1 loss);
     one step of a PyanNet with a BiLSTM of H = 512 at 32 x 10 s (one
     forward and one backward kernel launch a layer, no plain recurrence
     on the card, its time split); the segmentation ``evaluate``
     (frame-level DER) of full-width PyanNet on the development file,
     card against CPU, with its forward launches.
 12. training speaker embeddings and separation: (y) ArcFace at its
     defaults (8 speakers x 4 chunks of 2-5 s) with full-width WeSpeaker
     ResNet34 on (x)'s speakers: one step card against CPU on the exact
     path (loss, every gradient and the prototypes', BatchNorm's and the
     first stage's within a stated bound with a float64 witness, running
     statistics unchanged), Trainer.fit (2 epochs x 5 steps: warm step,
     split, peak, losses, no LSTM launch), the best checkpoint through
     Model.from_pretrained and PretrainedSpeakerEmbedding, and
     speaker_verification.main on seeded trials (EER); (z) PixIT at its
     defaults with ToTaToNet and the WavLM-large branch: one step on 2
     chunks card against CPU ("highest"; WavLM-large at its widths and 6
     of its 24 layers), the kernel path against the
     all-plain one, pixit_optimizer's two rates after one step, then
     Trainer.fit with validation in batches of 16 (1 epoch x 3 steps:
     MoM share, LSTM forward and backward launches exact, warm step,
     split, peak, der/val).
 13. the entry points on the community-1 snapshot, read from its
     config.yaml (written by the port's YAML writer), over files of 10,
     3 and 1 minutes: (A) ``python -m pyannote_audio_tpu_torch apply``
     with no --device in a new process, its RTTM and JSON against the
     same pipeline in this process, the same command without a visible
     card (it must fail), and ``main`` in this process against
     ``apply_batch`` (LSTM launches equal), ``download`` on the card and
     with a hub id that resolves nowhere (it must fail); (B)
     DiarizationServer with a
     token on 127.0.0.1: four jobs at once from the port's client (each
     output equal to the pipeline's, batched with no failure and no
     retry, latency per request), the SDK, a wrong token (401) and a
     corrupt upload that fails only its own job; (C) ``benchmark`` on
     two files of (x)'s protocol from a YAML registry, its DER report
     against metrics/der; (D) ``optimize``, 4 trials then 2 resumed from
     the journal, each run one pass of the models (the training
     caches); (E) Calibration saved and read back through
     get_calibration, the TPE optimizer and get_devices, with no
     scikit-learn, safetensors or PyYAML loaded; (F) a cold server's
     first request: in a new process, apply on the 1-minute file with
     and without ``warmup(60)`` before it (times, launches, outputs).
 14. data parallelism and hub resolution: (G) SpeakerDiarization over a
     mesh of two slots on the one card (``make_mesh(devices=["cuda:0",
     "cuda:0"])``) on 10 + 3 min through ``apply_batch`` and file by
     file, against the single-device run by the near-tie rule of
     (g)-(i), its LSTM launches twice the single run's, warm walls and
     peaks; (H) DistributedDataParallel, two gloo ranks on cuda:0
     (``torch.multiprocessing.spawn``): (x)'s PyanNet on its protocol,
     a batch of 32 (16 per rank), 1 epoch x 3 steps and one validation,
     against the single-process fit (losses, der/val, forward and
     backward LSTM launches per rank), the checkpoint
     written once by rank 0 and reloaded, ``broadcast_from_host0`` and
     the task's cache path on both ranks; (H1) the same with one rank
     over NCCL; (I) ``Pipeline.from_pretrained`` on the community-1 hub
     id through a PYANNOTE_TPU_HUB root holding (l)'s snapshot and over
     HTTP from a 127.0.0.1 server into an empty cache, against the
     pipeline loaded from its directory. Every spawn joins within its
     own timeout. Nothing leaves the machine: HF_ENDPOINT points at a
     closed local port unless a check serves one.

The line before the last is a JSON object describing each kernel (the
forward's ``launches`` is the accelerator path's, ``launches_per_path``
has every path's and ``phase_walls_s`` the wall of each phase, also
logged above it; the backward's ``launches`` is (x)'s fit's);
the last line is {"ok": true, "device": {...}}. Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SAMPLE_RATE = 16000
FILE_MINUTES = (10.0, 3.0)
EXACT_MINUTES = (3.0,)
GATES = ("PYANNOTE_TPU_SEG_BF16", "PYANNOTE_TPU_SHARED_SINC",
         "PYANNOTE_TPU_SHARED_TRUNK", "PYANNOTE_TPU_CONV_FBANK")
# phase 6: bench.py's 60/20/10-minute mix plus the two files of phase 5;
# the long file that the automatic slice plan cuts into 3 slices; the
# forced slice length of check (g)
SERVING_MINUTES = (60.0, 20.0, 10.0) + FILE_MINUTES
LONG_MINUTES = 150.0
FORCED_SLICE_MINUTES = "3"
# the JAX package's plan_slices for 150 min at its defaults (6.0 GB
# budget, 20 s halo): (a, b) sample bounds, chunks i0:i1
LONG_PLAN = [(0, 58064000, 0, 3600), (57280000, 115664000, 3600, 7200),
             (114880000, 144000000, 7200, 8991)]
BATCH_SIZE = 256
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.6,
                         "min_cluster_size": 1}}
# kernel vs plain version in the same precision, at every shape: float32
# sums in another order ("highest" as before; "high" about 12x the 8e-7
# measured on an H100); in "default" an h that lands one bf16 step apart
# where two float32 sums round differently, damped by the recurrence
# (about 4x the 2.7e-4 measured)
KERNEL_ATOL = {"default": 1e-3, "high": 1e-5, "highest": 1e-4}
# the same pipeline on the CPU (plain LSTM, CPU convolutions) on a short
# file: float32 sums in another order through 589 recurrent steps
REFERENCE_LOGP_ATOL = 1e-3
REFERENCE_EMBEDDING_RTOL = 1e-3
# phase 5 bounds: the shared float32 front-end against per-chunk forwards
# (the JAX package's tests/test_shared_sinc.py bound); bf16 SincNet
# against float32 (10x the 2.1e-3 that full-width random weights give on
# the CPU); whole-file fbank slices against per-chunk fbank; panels
# against one unpanelled trunk pass (float32: summation order; bf16: the
# JAX package's tests/test_shared_trunk.py bound, panel shapes round
# differently); shared-trunk embeddings against the exact path as cosine
# over the active (chunk, speaker) pairs (the JAX package's bounds)
SHARED_SINC_ATOL = 1e-4
BF16_SINC_ATOL = 2e-2
SHARED_FBANK_ATOL = 1e-3
PANEL_F32_ATOL = 1e-3
PANEL_BF16_RTOL, PANEL_BF16_ATOL = 5e-2, 6e-2
SHARED_TRUNK_MIN_COS, SHARED_TRUNK_MEAN_COS = 0.7, 0.85
# (f) the LSTM's bf16 products against float32 on whole PyanNet log-probs:
# the bound of bf16 SincNet against float32
LSTM_DEFAULT_LOGP_ATOL = 2e-2
# each fbank power spectrum (composed conv, DFT matmul, cuFFT) against a
# float64 fbank on the golden input: the JAX package's golden fbank bound
# (tests/test_fbank.py)
FBANK_SPECTRA_ATOL = 2e-3
# (g), (h): sliced runs against whole-file ones. Slices give cuDNN other
# shapes, so bf16 sums may round in another order: every powerset flip
# must be a near tie (its margin within twice the log-prob error), the
# hard clusters equal outside the chunks a flip touches, reconstructed
# frames differing only where such a chunk feeds them, segment
# boundaries within 0.05 s when nothing flipped, and the embeddings on
# one segmentation at cosine > 0.999 over the active (chunk, speaker)
# pairs (tests/test_longfile.py's bound). (i): apply_batch runs the same
# programs as apply, so its results must be equal.
SLICED_BOUNDARY_TOL = 0.05
SLICED_EMBEDDING_MIN_COS = 0.999


def log(message: str) -> None:
    print(message, flush=True)


def synth(minutes: float, seed: int, rate: int = SAMPLE_RATE) -> np.ndarray:
    """Synthetic "conversation": harmonic speakers + silences, PCM16-exact
    (the recipe of the JAX package's bench.py), at ``rate`` Hz."""
    rng = np.random.default_rng(seed)
    n = int(minutes * 60 * rate)
    t = np.arange(n) / rate
    wav = 0.003 * rng.standard_normal(n).astype(np.float32)
    segment = 5.0
    for i, start in enumerate(np.arange(0.0, minutes * 60 - segment, 7.0)):
        f0 = [140.0, 210.0, 320.0][(i + seed) % 3]
        i0, i1 = int(start * rate), int((start + segment) * rate)
        tt = t[i0:i1]
        wav[i0:i1] += (0.2 * np.sin(2 * np.pi * f0 * tt)
                       * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3 * tt)))
                       ).astype(np.float32)
    return np.round(wav * 32768.0).clip(-32768, 32767).astype(
        np.float32) / np.float32(32768.0)


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def set_gates(value) -> None:
    """Force the accelerator gates to ``value`` ("0" / "1"), or unset them
    (None: on by default on a CUDA device)."""
    for name in GATES:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def segmentation_batches(file_minutes=None, chunk_seconds=10.0,
                         batch: int = BATCH_SIZE) -> list:
    """Batch sizes (of ``batch`` chunks) the main path gives its
    segmentation model, file after file (of FILE_MINUTES by default), on
    chunks of ``chunk_seconds`` with a step of a tenth of that."""
    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    sizes = []
    for minutes in file_minutes or FILE_MINUTES:
        starts, _ = _chunk_grid(int(minutes * 60 * SAMPLE_RATE),
                                int(chunk_seconds * SAMPLE_RATE),
                                int(chunk_seconds * SAMPLE_RATE) // 10)
        sizes += [min(batch, len(starts) - b)
                  for b in range(0, len(starts), batch)]
    return sizes


def phase_environment() -> str:
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    log(card)
    log(f"torch's TF32 flags at their defaults: "
        f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    """Every native library of the path, each compiler started at once:
    the LSTM kernel and its backward (nvcc), the audio runtime (g++), and
    the FFmpeg codec (g++, built only where FFmpeg's headers are found)."""
    from concurrent.futures import ThreadPoolExecutor

    from pyannote_audio_tpu_torch.utils import native
    from pyannote_audio_tpu_torch.utils.build import build, build_host
    with ThreadPoolExecutor(4) as pool:
        kernels = [pool.submit(build, name) for name in
                   ("lstm_recurrence", "lstm_recurrence_backward",
                    "tf32x3_gemm")]
        audio = pool.submit(build_host, "pat_audio")
        codec = pool.submit(native.codec_available)
        infos, audio_info, has_codec = ([k.result() for k in kernels],
                                        audio.result(), codec.result())
    for info in infos:
        log(f"built {info['path'].name} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    log(f"built {audio_info['path'].name} in {audio_info['seconds']:.2f} s "
        f"(g++); FFmpeg codec library built: {has_codec}")


def layer_inputs(device, T, B, D_in, H, D, seed=0):
    """xw as the main path makes it (x @ W_ih^T + b, x ~ N(0, 1)) and
    W_hh, torch.nn.LSTM's init; also x, W_ih and b."""
    gen = torch.Generator().manual_seed(seed)
    bound = H ** -0.5
    x = torch.randn(T, B, D_in, generator=gen)
    w_ih = (torch.rand(D * 4 * H, D_in, generator=gen) * 2 - 1) * bound
    b = (torch.rand(D * 4 * H, generator=gen) * 2 - 1) * 2 * bound
    w_hh = (torch.rand(D, 4 * H, H, generator=gen) * 2 - 1) * bound
    x, w_ih, b, w_hh = (t.to(device) for t in (x, w_ih, b, w_hh))
    return (x @ w_ih.t() + b).contiguous(), w_hh, (x, w_ih, b)


def lstm_bound(T, B, H, D, precision, packed_bytes) -> dict:
    """Least time of one launch on an H100 SXM at 700 W: bytes (xw read,
    out written, packed W_hh read, once each) over 3.35 TB/s against the
    recurrent product's operations (2*T*B*D*4H*H, three bf16 passes for
    "high") over 989 TFLOP/s bf16 or 67 TFLOP/s float32. For "highest",
    ``bound_3xtf32_ms`` is the streamed route's: the product as three TF32
    passes at 495 TFLOP/s dense on the tensor cores (None otherwise)."""
    moved = 4 * T * B * D * 4 * H + 4 * T * B * D * H + packed_bytes
    product = 2 * T * B * D * 4 * H * H
    flops = product * (3 if precision == "high" else 1)
    rate = 67e12 if precision == "highest" else 989e12
    bytes_ms, ops_ms = moved / 3.35e12 * 1e3, flops / rate * 1e3
    tf32_ms = 3 * product / 495e12 * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_3xtf32_ms": max(bytes_ms, tf32_ms)
            if precision == "highest" else None}


def library_lstm_ms(device, T, B, D_in, H,
                    dtypes=("float32", "float16", "bfloat16")) -> dict:
    """torch.nn.LSTM (cuDNN) over the same layer, whole, of ``dtypes``:
    float32 under torch's default flags ("float32": ``cudnn.allow_tf32``
    is True, so cuDNN may run its products in TF32; the yardstick of every
    record since the first port), float32 with TF32 off beside it
    ("float32_exact", under ``exact_float32``), then fp16 and bf16 where
    cuDNN takes them (None where not). The yardstick only: the port never
    calls cuDNN's LSTM."""
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    lstm = torch.nn.LSTM(D_in, H, bidirectional=True).to(device)
    x = torch.randn(T, B, D_in, device=device)
    times = {}
    with torch.inference_mode():
        for name in dtypes:
            dtype = getattr(torch, name)
            layer, xd = lstm.to(dtype), x.to(dtype)
            layer.flatten_parameters()  # one cuDNN weight buffer
            try:
                times[name] = cuda_ms(lambda: layer(xd), runs=10)
                if name == "float32":
                    with exact_float32():
                        times["float32_exact"] = cuda_ms(lambda: layer(xd),
                                                         runs=10)
            except RuntimeError as err:
                log(f"cuDNN LSTM in {name}: not taken ({err})")
                times[name] = None
    return times


def phase_kernels(device: torch.device) -> dict:
    """LSTM kernel vs its plain version in each precision; returns the
    kernel's record (its main-path fields are the "default" mode's)."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import (
        lstm_bidirectional_recurrence, prepare_recurrent_weights)

    # PyanNet on 10 s chunks: T = 589 frames, B = every batch size of the
    # whole files the main paths segment (256 and each file's tail: phases
    # 4-5, phase 6's serving list, phase 13's files and (x)'s two files
    # of (C) and (D)), H = 128; layer 1, reading the 256 of layer 0 (a
    # layer's D_in does not reach the kernel, whose input is the projected
    # xw)
    main_batches = set(segmentation_batches()) | set(segmentation_batches(
        SERVING_MINUTES)) | set(segmentation_batches(ENTRY_MINUTES)) | set(
        segmentation_batches((TRAIN_FILE_MINUTES,) * 2))
    shapes = [(f"main B={B} layer 1", 589, B, 256, 128, 2)
              for B in sorted(main_batches, reverse=True)]
    # phase 14's shards, once each (a layer's D_in does not reach the
    # kernel, whose input is the projected xw)
    shapes += [(name, T, B, D_in, 128, 2)
               for name, T, B, D_in in phase14_lstm_shapes()]
    # phase 8's multi-label PyanNet on 5 s chunks: T = 293 frames, every
    # batch size of its 10-minute file, layer 0 and layers 1-3
    shapes += [(f"5 s chunks B={B} layer {name}", 293, B, D_in, 128, 2)
               for B in sorted(set(segmentation_batches(
                   FILE_MINUTES[:1], 5.0)), reverse=True)
               for name, D_in in (("0", 60), ("1-3", 256))]
    # phase 10's shapes: DPRNN's intra-chunk (T = chunk size, B = chunks x
    # 102 folds) and inter-chunk (T = 102 folds, B = chunks x 100 frames)
    # BiLSTMs at a full batch and the 3-minute file's tail, and
    # SSeRiouSS's 4-layer BiLSTM over WavLM-base on 10 s chunks (layer 0
    # reads 768 features, layers 1-3 the 256 of the layer before)
    shapes += [(name, T, B, D_in, 128, 2)
               for name, T, B, D_in in phase10_lstm_shapes()]
    shapes += [("B=1 T=1 H=8", 1, 1, 5, 8, 2),
               ("H=96", 33, 4, 60, 96, 2),
               ("B=3", 40, 3, 60, 128, 2),
               ("H=8 one direction", 17, 5, 60, 8, 1),
               ("H=10 (4-byte copies)", 21, 9, 60, 10, 2),
               ("H=256 B=20", 33, 20, 60, 256, 2)]
    worst = dict.fromkeys(KERNEL_ATOL, 0.0)
    for name, T, B, D_in, H, D in shapes:
        xw, w_hh, _ = layer_inputs(device, T, B, D_in, H, D)
        for precision, limit in KERNEL_ATOL.items():
            out = lstm_bidirectional_recurrence(xw, w_hh, precision)
            torch.cuda.synchronize()
            ref = lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
            err = (out - ref).abs().max().item()
            worst[precision] = max(worst[precision], err)
            log(f"lstm_recurrence {precision:8s} {name}: xw "
                f"{tuple(xw.shape)} -> {tuple(out.shape)}, max_abs_err "
                f"{err:.3e} (limit {limit})")
            if not (torch.isfinite(out).all() and err <= limit):
                raise AssertionError(
                    f"LSTM kernel ({precision}) disagrees with its plain "
                    f"version at {name}: {err} > {limit}")

    T, B, D_in, H, D = 589, 256, 256, 128, 2
    xw, w_hh, (x, w_ih, b) = layer_inputs(device, T, B, D_in, H, D)
    modes = {}
    for precision in KERNEL_ATOL:
        prepared = prepare_recurrent_weights(w_hh, precision)
        kernel_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
            xw, w_hh, precision, prepared), runs=20)
        plain_ms = cuda_ms(lambda: lstm_bidirectional_recurrence_plain(
            xw, w_hh, precision), runs=3, warmup=1)
        kernel_ms_2 = cuda_ms(lambda: lstm_bidirectional_recurrence(
            xw, w_hh, precision, prepared), runs=20)
        bound = lstm_bound(T, B, H, D, precision,
                           prepared.packed.numel()
                           * prepared.packed.element_size())
        modes[precision] = dict(ms=min(kernel_ms, kernel_ms_2),
                                plain_ms=plain_ms,
                                max_abs_err=worst[precision], **bound)
        log(f"lstm_recurrence {precision} at (589, 256, 1024) -> (589, 256, "
            f"256): kernel {kernel_ms:.3f} / {kernel_ms_2:.3f} ms (median "
            f"of 20, before and after the plain), plain {plain_ms:.3f} ms "
            f"(median of 3); bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']})")

    # the whole layer, like for like with cuDNN's LSTM: the port's hoisted
    # projection (float32 matmul) + the kernel at the main path's "default"
    prepared = prepare_recurrent_weights(w_hh, "default")
    projection_ms = cuda_ms(lambda: x @ w_ih.t() + b, runs=20)
    layer_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
        (x @ w_ih.t() + b).contiguous(), w_hh, "default", prepared),
        runs=20)
    library = library_lstm_ms(device, T, B, D_in, H)
    log(f"layer (589, 256, 256) -> (589, 256, 256), bidirectional H=128: "
        f"port projection {projection_ms:.3f} ms + kernel (default) = "
        f"{layer_ms:.3f} ms; cuDNN torch.nn.LSTM "
        + ", ".join(f"{k} {'%.3f ms' % v if v is not None else 'n/a'}"
                    for k, v in library.items()))
    # the same at T = 293 (5 s chunks), "default" as the main path runs it
    T5 = 293
    xw5, w_hh5, (x5, w_ih5, b5) = layer_inputs(device, T5, B, D_in, H, D)
    prepared5 = prepare_recurrent_weights(w_hh5, "default")
    kernel5_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
        xw5, w_hh5, "default", prepared5), runs=20)
    plain5_ms = cuda_ms(lambda: lstm_bidirectional_recurrence_plain(
        xw5, w_hh5, "default"), runs=3, warmup=1)
    layer5_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
        (x5 @ w_ih5.t() + b5).contiguous(), w_hh5, "default", prepared5),
        runs=20)
    bound5 = lstm_bound(T5, B, H, D, "default", prepared5.packed.numel()
                        * prepared5.packed.element_size())
    library5 = library_lstm_ms(device, T5, B, D_in, H)
    t293 = {"ms": kernel5_ms, "plain_ms": plain5_ms, "layer_ms": layer5_ms,
            "library": library5, **bound5}
    log(f"lstm_recurrence default at (293, 256, 1024) -> (293, 256, 256): "
        f"kernel {kernel5_ms:.3f} ms, plain {plain5_ms:.3f} ms; bound "
        f"{bound5['bound_ms']:.4f} ms ({bound5['bound_by']}); layer "
        f"(projection + kernel) {layer5_ms:.3f} ms; cuDNN torch.nn.LSTM "
        + ", ".join(f"{k} {'%.3f ms' % v if v is not None else 'n/a'}"
                    for k, v in library5.items()))

    # each phase-10 and phase-14 shape: the kernel in each precision
    # against its bound, the plain version ("default") and cuDNN's whole
    # layer
    new_shapes, mesh_shapes = {}, {}
    for name, T, B, D_in in phase10_lstm_shapes() + phase14_lstm_shapes():
        xw, w_hh, _ = layer_inputs(device, T, B, D_in, H, D)
        entry = {"T": T, "B": B, "D_in": D_in}
        # phase 14's shapes run "default" only (held in every mode above)
        timed_modes = ("default",) if name.startswith("phase 14") \
            else KERNEL_ATOL
        for precision in timed_modes:
            prepared = prepare_recurrent_weights(w_hh, precision)
            entry[precision] = dict(
                ms=cuda_ms(lambda: lstm_bidirectional_recurrence(
                    xw, w_hh, precision, prepared), runs=10),
                **lstm_bound(T, B, H, D, precision,
                             prepared.packed.numel()
                             * prepared.packed.element_size()))
        entry["plain_ms"] = cuda_ms(
            lambda: lstm_bidirectional_recurrence_plain(xw, w_hh, "default"),
            runs=3, warmup=1)
        del xw
        entry["library"] = library_lstm_ms(device, T, B, D_in, H)
        (mesh_shapes if name.startswith("phase 14") else new_shapes)[name] \
            = entry
        log(f"lstm_recurrence at {name} (T={T}, B={B}, D_in={D_in}): "
            + "; ".join(f"{p} {entry[p]['ms']:.3f} ms (bound "
                        f"{entry[p]['bound_ms']:.4f} ms, "
                        f"{entry[p]['bound_by']})" for p in timed_modes)
            + f"; plain (default) {entry['plain_ms']:.3f} ms; cuDNN "
            "torch.nn.LSTM layer "
            + ", ".join(f"{k} {'%.3f ms' % v if v is not None else 'n/a'}"
                        for k, v in entry["library"].items()))
        torch.cuda.empty_cache()

    main = modes["default"]
    return {"name": "lstm_recurrence", "route": "cuda",
            "source": "pyannote_audio_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "pyannote_audio_tpu/ops/pallas_lstm.py:100",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": library["float32"], "modes": modes,
            "layer_ms": layer_ms, "projection_ms": projection_ms,
            "library": library, "t293": t293, "phase10_shapes": new_shapes,
            "phase14_shapes": mesh_shapes}


# -- phase 3c: the 3xTF32 GEMM ------------------------------------------------

# the float32 WavLM-base trunk's products at one segmentation batch (32 ten-
# second chunks, 499 frames): the linears (name, N, K, GELU) at M = 32 x 499,
# and convs 1-6 (name, input frames, kernel, GELU) over (32, frames, 512)
TF32X3_ROWS = 32 * 499
TF32X3_LINEARS = [("q, k, v", 2304, 768, False),
                  ("out_proj", 768, 768, False),
                  ("intermediate_dense + GELU", 3072, 768, True),
                  ("output_dense", 768, 3072, False),
                  ("feature projection", 768, 512, False)]
TF32X3_CONVS = [("conv 1", 31999, 3), ("conv 2", 15999, 3),
                ("conv 3", 7999, 3), ("conv 4", 3999, 3),
                ("conv 5", 1999, 2), ("conv 6", 999, 2)]
TF32X3_PEAK = 495e12  # TF32 dense, H100 SXM: three passes a product


def tf32x3_row(name, flops, kernel, plain, library, expected) -> dict:
    """Times (ms, CUDA-event medians) and errors (max |C - C64| / max
    |C64|) of one shape: the kernel beside its bound (3 TF32 passes at
    495 TFLOP/s), the plain version, and the library's float32 call."""
    bound = 3 * flops / TF32X3_PEAK * 1e3
    row = {"name": name, "gflop": flops / 1e9, "bound_ms": bound}
    with torch.inference_mode():
        for key, fn in (("kernel", kernel), ("plain", plain),
                        ("library", library)):
            out = fn()
            row[f"{key}_err"] = ((out.double() - expected).abs().max()
                                 / expected.abs().max()).item()
            del out
            row[f"{key}_ms"] = cuda_ms(fn, runs=3 if key == "plain" else 20)
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    row["bound_share"] = bound / row["kernel_ms"]
    log(f"(3c) {name}: kernel {row['kernel_ms']:.3f} ms "
        f"({row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f} % of "
        f"its bound {bound:.3f} ms), plain {row['plain_ms']:.3f} ms, "
        f"library (float32, TF32 off) {row['library_ms']:.3f} ms "
        f"({flops / row['library_ms'] / 1e9:.1f} TFLOP/s); max error / "
        f"max |C64|: kernel {row['kernel_err']:.3e}, library "
        f"{row['library_err']:.3e}, plain {row['plain_err']:.3e}")
    if not row["kernel_err"] <= 4 * row["library_err"]:
        raise AssertionError(f"(3c) {name}: the kernel is less accurate "
                             f"than 4x the library's float32 product")
    return row


def phase_tf32x3(device: torch.device, card: str) -> dict:
    """The 3xTF32 GEMM (``ops/tf32x3_gemm.py``) at the WavLM-base trunk's
    shapes, against a float64 product, beside its bound, the plain version
    and the library's float32 call under ``exact_float32`` (cuBLAS for the
    linears, cuDNN's conv on the (B, C, T) layout the trunk used before);
    then the kernel's launches and the torch route's calls over one
    SSeRiouSS file through SpeakerDiarization."""
    import torch.nn.functional as F
    from pyannote_audio_tpu_torch.ops import tf32x3_gemm as tf32x3
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    log(f"phase 3c, the 3xTF32 GEMM, on {card}")
    g = torch.Generator(device=device).manual_seed(21)
    rows = []
    for name, N, K, gelu in TF32X3_LINEARS:
        a = torch.randn(TF32X3_ROWS, K, generator=g, device=device)
        layer = torch.nn.Linear(K, N).to(device)
        w, b = layer.weight.detach(), layer.bias.detach()
        act = F.gelu if gelu else (lambda y: y)
        expected = act(a.double() @ w.double().T + b.double())
        hi, lo = tf32x3.split_tf32(w)

        def library(a=a, w=w, b=b, act=act):
            with exact_float32():
                return act(F.linear(a, w, b))

        rows.append(tf32x3_row(
            name, 2 * TF32X3_ROWS * N * K,
            lambda a=a, layer=layer, gelu=gelu: tf32x3.linear(a, layer,
                                                              gelu),
            lambda a=a, hi=hi, lo=lo, b=b, gelu=gelu:
                tf32x3.tf32x3_matmul_plain(a, hi, lo, b, gelu),
            library, expected))
        del a, expected
    for name, frames, kernel in TF32X3_CONVS:
        x = torch.randn(32, frames, 512, generator=g, device=device)
        conv = torch.nn.Conv1d(512, 512, kernel, stride=2,
                               bias=False).to(device)
        w = conv.weight.detach().permute(0, 2, 1).reshape(512, -1)
        expected = F.gelu(tf32x3.conv_view(x.double(), kernel, 2)
                          @ w.double().T)
        hi, lo = tf32x3.split_tf32(w)
        channels_first = x.transpose(1, 2).contiguous()

        def library(x=channels_first, conv=conv):
            with exact_float32():
                return F.gelu(conv(x)).transpose(1, 2)

        rows.append(tf32x3_row(
            f"{name} + GELU", 2 * 32 * ((frames - kernel) // 2 + 1) * 512
            * kernel * 512,
            lambda x=x, conv=conv: tf32x3.strided_conv(x, conv, gelu=True),
            lambda x=x, kernel=kernel, hi=hi, lo=lo:
                tf32x3.tf32x3_matmul_plain(tf32x3.conv_view(x, kernel, 2),
                                           hi, lo, None, True),
            library, expected))
        del x, channels_first, expected
    torch.cuda.empty_cache()
    return {"shapes": rows, "file": tf32x3_file(device, card)}


def tf32x3_file(device: torch.device, card: str) -> dict:
    """``.launches`` and ``.torch_calls`` of the 3xTF32 GEMM over one
    1-minute file through SpeakerDiarization with a seeded SSeRiouSS
    (WavLM-base) and ResNet34: every eligible product of the trunk takes
    the kernel in inference."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.sseriouss import \
        SSeRiouSS
    from pyannote_audio_tpu_torch.ops import tf32x3_gemm as tf32x3
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    pipeline = SpeakerDiarization(
        segmentation=SSeRiouSS(generator=torch.Generator().manual_seed(50)),
        embedding=WeSpeakerResNet34(generator=torch.Generator()
                                    .manual_seed(2)),
        segmentation_batch_size=32, embedding_batch_size=32, device=device)
    pipeline.instantiate(PARAMS)
    with tempfile.TemporaryDirectory() as tmp:
        files = write_files(Path(tmp), (1.0,))
        before = (tf32x3.tf32x3_gemm.launches,
                  tf32x3.tf32x3_gemm.torch_calls)
        wall = wall_seconds(lambda: run_batch(pipeline, files))
    launches = tf32x3.tf32x3_gemm.launches - before[0]
    torch_calls = tf32x3.tf32x3_gemm.torch_calls - before[1]
    batches = len(segmentation_batches((1.0,), SSL_CHUNK_SECONDS, SSL_BATCH))
    expected = batches * (6 + 1 + 4 * 12)
    log(f"(3c) one 1-minute SSeRiouSS file through SpeakerDiarization "
        f"({wall:.2f} s, first call; {card}): tf32x3_gemm.launches "
        f"{launches} (expected {expected}: {batches} batches x 55), "
        f".torch_calls {torch_calls}")
    if launches != expected or torch_calls != 0:
        raise AssertionError("(3c) the trunk's products did not all take "
                             "the 3xTF32 kernel")
    return {"launches": launches, "torch_calls": torch_calls,
            "batches": batches}


def build_pipeline(segmentation, embedding, device):
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    pipeline = SpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=BATCH_SIZE, embedding_batch_size=BATCH_SIZE,
        device=device)
    return pipeline.instantiate(PARAMS)


def traced_run(pipeline, file: dict):
    """Run ``pipeline`` on ``file`` and keep what its stages decided: the
    hard segmentation (C, F, S), the hard clusters (C, S) and the
    reconstructed (frames, speakers) matrices, normal and exclusive."""
    seen = {"binary": []}
    slide, cluster = pipeline._segmentation.slide, pipeline.clustering
    to_annotation = pipeline.to_annotation

    def slide_(*args, **kwargs):
        out = slide(*args, **kwargs)
        seen["scores"] = out.data.cpu().numpy()
        seen["window"] = out.sliding_window
        return out

    def cluster_(*args, **kwargs):
        out = cluster(*args, **kwargs)
        seen["clusters"] = np.array(out[0])
        seen["embeddings"] = np.array(args[0])
        return out

    def to_annotation_(binarized, **kwargs):
        seen["binary"].append(binarized.data)
        return to_annotation(binarized, **kwargs)

    pipeline._segmentation.slide = slide_
    pipeline.clustering = cluster_
    pipeline.to_annotation = to_annotation_
    try:
        out = pipeline(dict(file), max_speakers=4)
    finally:
        del pipeline._segmentation.slide, pipeline.to_annotation
        pipeline.clustering = cluster
    return out, seen


def card_vs_cpu(pipeline, cpu_pipeline, device, wav: np.ndarray,
                label: str, check: bool = True,
                logp_atol: float = REFERENCE_LOGP_ATOL):
    """PyanNet's log-probabilities on every chunk of ``wav`` and the
    embeddings of 8 chunks, on the card and on the CPU; printed, and held
    to ``logp_atol`` / REFERENCE_EMBEDDING_RTOL when ``check``.
    Returns (logp, logp_ref, logp_err, emb_err)."""
    from pyannote_audio_tpu_torch.core.inference import chunk_views
    chunks = chunk_views(torch.from_numpy(wav), 10 * SAMPLE_RATE,
                         SAMPLE_RATE)
    seg_gpu = pipeline._segmentation.model
    seg_cpu = cpu_pipeline._segmentation.model
    emb_gpu, emb_cpu = pipeline._embedding, cpu_pipeline._embedding
    masks = (torch.rand(8, 3, 589, generator=torch.Generator()
                        .manual_seed(1)) > 0.5).float()
    with torch.inference_mode():
        logp = seg_gpu(chunks.contiguous().to(device)).cpu()
        logp_ref = seg_cpu(chunks.contiguous())
        emb = emb_gpu.embed(emb_gpu.frames(chunks[:8].contiguous()
                                           .to(device)),
                            masks.to(device)).cpu()
        emb_ref = emb_cpu.embed(emb_cpu.frames(chunks[:8].contiguous()),
                                masks)
    logp_err = (logp - logp_ref).abs().max().item()
    emb_err = ((emb - emb_ref).abs().max() / emb_ref.abs().max()).item()
    log(f"{label}: PyanNet log-prob max_abs_err {logp_err:.3e} on "
        f"{len(chunks)} chunks (limit {logp_atol:.3e}), embedding "
        f"max relative err {emb_err:.3e} on 8 chunks (limit "
        f"{REFERENCE_EMBEDDING_RTOL})")
    if not check:
        return logp, logp_ref, logp_err, emb_err
    if not (logp.shape == (len(chunks), 589, 7)
            and torch.isfinite(logp).all()
            and logp_err <= logp_atol):
        raise AssertionError(f"{label}: PyanNet on the card disagrees with "
                             f"the CPU")
    if not (emb.shape == (8, 3, 256) and torch.isfinite(emb).all()
            and emb_err <= REFERENCE_EMBEDDING_RTOL):
        raise AssertionError(f"{label}: ResNet34 on the card disagrees "
                             f"with the CPU")
    return logp, logp_ref, logp_err, emb_err


def check_against_cpu(pipeline, cpu_pipeline, device, minutes=0.5,
                      label="card vs CPU",
                      logp_atol: float = REFERENCE_LOGP_ATOL) -> None:
    """The card's pipeline against the same weights on the CPU, on a file
    of ``minutes`` (30 s by default), the log-probabilities within
    ``logp_atol``.

    PyanNet's log-probabilities are held on every chunk of the file, the
    embeddings on 8 chunks. Float32 sums in another order can flip the
    powerset argmax where two classes tie within the log-prob error; each
    such flip must be a near tie, the hard clusters must be equal, and the
    reconstructed speaker frames may differ only at the output frames
    that a flip feeds. Without a flip, both Annotations must have the same
    tracks with boundaries within one frame.
    """
    wav = synth(minutes, seed=7)[None]
    logp, logp_ref, logp_err, _ = card_vs_cpu(pipeline, cpu_pipeline,
                                              device, wav, label,
                                              logp_atol=logp_atol)

    file = {"waveform": wav, "sample_rate": SAMPLE_RATE, "uri": "short"}
    out, ours = traced_run(pipeline, file)
    ref, theirs = traced_run(cpu_pipeline, file)
    flips = np.argwhere((ours["scores"] != theirs["scores"]).any(-1))
    top_gpu = logp.argmax(-1)
    top_cpu = logp_ref.argmax(-1)
    margins = [(logp_ref[c, f, top_cpu[c, f]]
                - logp_ref[c, f, top_gpu[c, f]]).item() for c, f in flips]
    log(f"{label} pipeline on {minutes:g} min: {len(flips)} of "
        f"{top_cpu.numel()} chunk frames flip their powerset class, CPU "
        f"margins {['%.3e' % m for m in margins]}")
    if max(margins, default=0.0) > 2 * logp_err:
        raise AssertionError("a segmentation flip is not a near tie")
    if not np.array_equal(ours["clusters"], theirs["clusters"]):
        raise AssertionError(f"hard clusters differ: {ours['clusters']} "
                             f"vs {theirs['clusters']}")
    frames = pipeline._segmentation.model.receptive_field
    offsets, _, _ = pipeline._aggregation_grid(
        ours["window"], frames, len(ours["scores"]))
    fed = {int(offsets[c] + f) for c, f in flips}
    for name, a, b in zip(("normal", "exclusive"), ours["binary"],
                          theirs["binary"]):
        differ = np.flatnonzero((a != b).any(-1)) if a.shape == b.shape \
            else None
        if differ is None or not set(differ.tolist()) <= fed:
            raise AssertionError(f"{name} reconstruction differs beyond "
                                 f"the flipped frames: {differ}")
        log(f"  {name} reconstruction: {len(differ)} of {len(a)} output "
            f"frames differ, none beyond the flipped frames")
    a = list(out.speaker_diarization.itertracks(yield_label=True))
    b = list(ref.speaker_diarization.itertracks(yield_label=True))
    log(f"  {len(a)} vs {len(b)} segments, labels "
        f"{out.speaker_diarization.labels()} vs "
        f"{ref.speaker_diarization.labels()}")
    if not a:
        raise AssertionError(f"{label}: empty diarization")
    if not len(flips) and not (len(a) == len(b) and all(
            la == lb and abs(sa.start - sb.start) <= frames.step
            and abs(sa.end - sb.end) <= frames.step
            for (sa, _, la), (sb, _, lb) in zip(a, b))):
        raise AssertionError(f"{label}: the pipeline on the card disagrees "
                             f"with the CPU")


def make_models(compute_dtype: torch.dtype):
    """Full published widths: sinc stride 10, BiLSTM 2 x 128, 2 x Linear
    128, 7 powerset classes; ResNet34 (3, 4, 6, 3) x 32 channels, 80 mel
    bins, 256-d embeddings. Seed 1 gives a random PyanNet that marks
    speech (most seeds' random heads settle on one class everywhere)."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    return (PyanNet(generator=torch.Generator().manual_seed(1)),
            WeSpeakerResNet34(compute_dtype=compute_dtype,
                              generator=torch.Generator().manual_seed(2)))


def write_files(workdir: Path, file_minutes) -> list:
    from pyannote_audio_tpu_torch.core.io import write_wav
    files = []
    for k, minutes in enumerate(file_minutes):
        path = workdir / f"synth_{k}_{minutes:g}_min.wav"
        if not path.exists():
            write_wav(path, synth(minutes, seed=k)[None], SAMPLE_RATE)
        files.append({"audio": str(path), "uri": path.stem})
    return files


STAGES = ("decode", "segmentation", "trunk (early dispatch)",
          "count + stats", "embeddings", "clustering (host)",
          "reconstruction", "annotation (host)")


@contextlib.contextmanager
def stage_timer(pipeline, seconds: dict):
    """Time each stage of ``pipeline.apply``, the card synchronised on
    both sides of every stage (so queued work is charged to the stage
    that queued it, and no stage overlaps another)."""
    from pyannote_audio_tpu_torch.pipelines import speaker_diarization as sd

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + \
                time.perf_counter() - start
            return out
        return run

    attributes = [(pipeline, "_audio", "decode"),
                  (pipeline._segmentation, "slide", "segmentation"),
                  (pipeline, "_start_shared_trunk", "trunk (early dispatch)"),
                  (sd, "fused_count_stats", "count + stats"),
                  (pipeline, "get_embeddings", "embeddings"),
                  (pipeline, "clustering", "clustering (host)"),
                  (sd, "fused_reconstruct", "reconstruction"),
                  (pipeline, "to_annotation", "annotation (host)")]
    saved = [(owner, attr, owner.__dict__.get(attr))
             for owner, attr, _ in attributes]
    for owner, attr, name in attributes:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        yield seconds
    finally:
        for owner, attr, value in saved:
            if value is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, value)


def wall_seconds(fn) -> float:
    """Host-clock seconds of ``fn()``, the card synchronised at both
    ends."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def run_batch(pipeline, files: list) -> list:
    return pipeline([dict(f) for f in files], max_speakers=4)


def run_one_by_one(pipeline, files: list) -> list:
    return [pipeline(dict(f), max_speakers=4) for f in files]


def timed_passes(pipeline, files: list, minutes: float, label: str) -> dict:
    """Wall-clock passes (nothing synchronised inside) through
    ``apply_batch`` and file by file, then one pass file by file with
    stage timers; prints them and returns the stage table."""
    wall = wall_seconds(lambda: run_batch(pipeline, files))
    sequential = wall_seconds(lambda: run_one_by_one(pipeline, files))
    seconds = {}
    with stage_timer(pipeline, seconds):
        staged = wall_seconds(lambda: run_one_by_one(pipeline, files))
    per_hour = 60.0 / minutes
    log(f"{label}: {wall:.3f} s for {minutes:g} min of audio through "
        f"apply_batch = {wall * per_hour:.3f} s per audio-hour; file by "
        f"file {sequential:.3f} s = {sequential * per_hour:.3f} s per "
        f"audio-hour (stage-timed pass {staged:.3f} s = "
        f"{staged * per_hour:.3f} s per audio-hour)")
    for name in STAGES:
        log(f"  {name:24s} {seconds.get(name, 0.0):8.3f} s")
    log(f"  {'other (host glue)':24s} "
        f"{staged - sum(seconds.values()):8.3f} s")
    return {"wall": wall, "staged": staged, "stages": seconds}


def check_outputs(files: list, outputs: list) -> None:
    from pyannote_audio_tpu_torch.core.annotation import Annotation
    for f, out in zip(files, outputs):
        ann = out.speaker_diarization
        if not isinstance(ann, Annotation) or not len(ann):
            raise AssertionError(f"{f['uri']}: expected a non-empty "
                                 f"Annotation, got {ann!r}")
        if not np.isfinite(out.speaker_embeddings).all():
            raise AssertionError(f"{f['uri']}: non-finite centroids")
        log(f"{f['uri']}: {len(ann)} segments, labels {ann.labels()}")


def reset_counts(pipeline) -> None:
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    lstm_bidirectional_recurrence.launches = 0
    pipeline.counts = dict.fromkeys(pipeline.counts, 0)
    pipeline._segmentation.counts = dict.fromkeys(
        pipeline._segmentation.counts, 0)


def read_counts(pipeline) -> dict:
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    return dict(pipeline.counts, **pipeline._segmentation.counts,
                lstm_launches=lstm_bidirectional_recurrence.launches)


@contextlib.contextmanager
def environ(values: dict):
    """Environment variables set to ``values`` (None: unset), then
    restored."""
    saved = {name: os.environ.get(name) for name in values}
    for name, value in values.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def lstm_precision_env(value):
    """PYANNOTE_TPU_LSTM_PRECISION set to ``value`` (None: unset), then
    restored."""
    return environ({"PYANNOTE_TPU_LSTM_PRECISION": value})


def phase_exact(device: torch.device, workdir: Path) -> None:
    """The exact path: gates off, float32 trunk and LSTM, held against
    the CPU."""
    with lstm_precision_env("highest"):
        return run_exact(device, workdir)


def run_exact(device: torch.device, workdir: Path) -> None:
    set_gates("0")
    segmentation, embedding = make_models(torch.float32)
    cpu_pipeline = build_pipeline(copy.deepcopy(segmentation),
                                  copy.deepcopy(embedding), "cpu")
    pipeline = build_pipeline(segmentation, embedding, device)
    check_against_cpu(pipeline, cpu_pipeline, device)
    del cpu_pipeline

    files = write_files(workdir, EXACT_MINUTES)
    batches = len(segmentation_batches(EXACT_MINUTES))
    reset_counts(pipeline)
    outputs = pipeline([dict(f) for f in files], max_speakers=4)
    torch.cuda.synchronize()
    counts = read_counts(pipeline)
    check_outputs(files, outputs)
    log(f"exact path counts: {counts}")
    # embedding batches are as many as segmentation batches (both 256)
    expected = {"whole_conv": 0, "whole_fbank": len(files),
                "trunk_panel_batches": 0, "chunk_trunk_batches": batches,
                "lstm_launches": 2 * batches}
    if counts != expected:
        raise AssertionError(f"the exact path ran other work than "
                             f"expected: {counts} != {expected}")
    timed_passes(pipeline, files, sum(EXACT_MINUTES), "exact path")
    return counts["lstm_launches"]


WIDE_PIPELINE_HIDDEN = 512


def phase_wide_lstm(device: torch.device, workdir: Path) -> int:
    """SpeakerDiarization whose PyanNet has a BiLSTM of H = 512 (the
    kernels' streamed route; its other widths published, its head
    calibrated on 8 chunks so that it marks speech) on the exact path,
    held against the same pipeline on the CPU on the 3-minute file by the
    near-tie rule of ``check_against_cpu``, then through ``apply`` on the
    card with its forward launches counted and timed. Returns the
    launches. The random head's logits barely move with the audio (a
    spread of about 1e-3), and the calibration multiplies them, and with
    them the card's and the CPU's float32 rounding differences, by its
    gain: so the uncalibrated model's log-probabilities are held to phase
    4's REFERENCE_LOGP_ATOL on the 30 s file's chunks, and the calibrated
    pipeline's to that limit times the gain."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    with exact_path():
        segmentation = PyanNet(lstm_hidden=WIDE_PIPELINE_HIDDEN,
                               generator=torch.Generator().manual_seed(1))
        from pyannote_audio_tpu_torch.core.inference import chunk_views
        chunks = chunk_views(torch.from_numpy(synth(0.5, seed=7)[None]),
                             10 * SAMPLE_RATE, SAMPLE_RATE).contiguous()
        card_raw = copy.deepcopy(segmentation).to(device)
        with torch.inference_mode():
            raw_err = float((card_raw(chunks.to(device)).cpu()
                             - segmentation(chunks)).abs().max())
        del card_raw
        log(f"H = {WIDE_PIPELINE_HIDDEN}, the uncalibrated model: log-prob "
            f"max_abs_err card vs CPU {raw_err:.3e} on {len(chunks)} chunks "
            f"(limit {REFERENCE_LOGP_ATOL})")
        if not raw_err <= REFERENCE_LOGP_ATOL:
            raise AssertionError(f"H = {WIDE_PIPELINE_HIDDEN}: PyanNet on "
                                 f"the card disagrees with the CPU")
        gain = calibrate_powerset(segmentation, torch.from_numpy(
            chunk_batch(1.0, 10.0, 8, seed=5)))
        log(f"H = {WIDE_PIPELINE_HIDDEN}: the head's calibration gain is "
            f"{gain:.3f}")
        embedding = WeSpeakerResNet34(
            compute_dtype=torch.float32,
            generator=torch.Generator().manual_seed(2))
        cpu_pipeline = build_pipeline(copy.deepcopy(segmentation),
                                      copy.deepcopy(embedding), "cpu")
        pipeline = build_pipeline(segmentation, embedding, device)
        start = time.perf_counter()
        check_against_cpu(pipeline, cpu_pipeline, device,
                          minutes=EXACT_MINUTES[0],
                          label=f"H = {WIDE_PIPELINE_HIDDEN} card vs CPU",
                          logp_atol=REFERENCE_LOGP_ATOL * max(gain, 1.0))
        log(f"H = {WIDE_PIPELINE_HIDDEN}: the hold against the CPU took "
            f"{time.perf_counter() - start:.1f} s")
        del cpu_pipeline
        files = write_files(workdir, EXACT_MINUTES)
        batches = len(segmentation_batches(EXACT_MINUTES))
        reset_counts(pipeline)
        outputs = pipeline([dict(f) for f in files], max_speakers=4)
        torch.cuda.synchronize()
        launches = read_counts(pipeline)["lstm_launches"]
        check_outputs(files, outputs)
        log(f"H = {WIDE_PIPELINE_HIDDEN} exact path: {launches} forward "
            f"kernel launches on {EXACT_MINUTES[0]:g} min (expected "
            f"{2 * batches}: 2 layers x {batches} batches)")
        if launches != 2 * batches:
            raise AssertionError(f"H = {WIDE_PIPELINE_HIDDEN}: {launches} "
                                 f"launches, expected {2 * batches}")
        wall = wall_seconds(lambda: run_batch(pipeline, files))
        log(f"H = {WIDE_PIPELINE_HIDDEN} exact path: {wall:.3f} s for "
            f"{EXACT_MINUTES[0]:g} min of audio through apply_batch (warm)")
    return launches


def check_shared_sinc(pipeline, waveform: torch.Tensor) -> None:
    """(a) Shared-sinc log-probs against per-chunk ones, both float32;
    then bf16 SincNet on the shared path against float32 per chunk."""
    inference = pipeline._segmentation
    powerset, inference._powerset = inference._powerset, None

    def logp(seg_bf16: str, shared: str) -> torch.Tensor:
        os.environ["PYANNOTE_TPU_SEG_BF16"] = seg_bf16
        os.environ["PYANNOTE_TPU_SHARED_SINC"] = shared
        return inference.slide(waveform, SAMPLE_RATE).data
    try:
        per_chunk = logp("0", "0")
        passes = inference.counts["whole_conv"]
        shared = logp("0", "1")
        bf16 = logp("1", "1")
        if inference.counts["whole_conv"] != passes + 2:
            raise AssertionError("the shared front-end did not run")
    finally:
        inference._powerset = powerset
        set_gates(None)
    err = (shared - per_chunk).abs().max().item()
    err_bf16 = (bf16 - per_chunk).abs().max().item()
    flips = (bf16.argmax(-1) != per_chunk.argmax(-1)).float().mean().item()
    log(f"(a) shared sinc front-end vs per-chunk, float32: log-prob "
        f"max_abs_err {err:.3e} on {len(per_chunk)} chunks (limit "
        f"{SHARED_SINC_ATOL}); bf16 SincNet (shared) vs float32 per chunk: "
        f"{err_bf16:.3e} (limit {BF16_SINC_ATOL}), powerset argmax "
        f"flips at {flips:.4%} of chunk frames")
    if not (torch.isfinite(shared).all() and err <= SHARED_SINC_ATOL):
        raise AssertionError("the shared sinc front-end disagrees with "
                             "per-chunk forwards")
    if not (torch.isfinite(bf16).all() and err_bf16 <= BF16_SINC_ATOL):
        raise AssertionError("bf16 SincNet is too far from float32")


def check_shared_fbank(pipeline, waveform: torch.Tensor) -> None:
    """(b) Whole-file fbank slices against the per-chunk fbank."""
    from pyannote_audio_tpu_torch.core.inference import pad_to_grid
    from pyannote_audio_tpu_torch.ops.fbank import fbank
    padded = pad_to_grid(waveform, 10 * SAMPLE_RATE, SAMPLE_RATE)
    feats = pipeline._whole_fbank(padded)
    chunks = padded[0].unfold(0, 10 * SAMPLE_RATE, SAMPLE_RATE)
    worst = 0.0
    for b in range(0, len(chunks), 64):
        ref = fbank(chunks[b:b + 64] * 32768.0, window_type="hamming")
        frames = ref.shape[1]
        ours = torch.stack([feats[c * 100:c * 100 + frames]
                            for c in range(b, b + len(ref))])
        worst = max(worst, (ours - ref).abs().max().item())
    log(f"(b) whole-file fbank {tuple(feats.shape)} sliced vs per-chunk "
        f"fbank on {len(chunks)} chunks: max_abs_err {worst:.3e} (limit "
        f"{SHARED_FBANK_ATOL})")
    if not worst <= SHARED_FBANK_ATOL:
        raise AssertionError("whole-file fbank slices disagree")


def check_panels(pipeline, waveform: torch.Tensor, label: str = "(c)"
                 ) -> None:
    """(c) The panelled trunk against one unpanelled pass over the same
    padded layout, float32 and bf16."""
    from pyannote_audio_tpu_torch.core.inference import pad_to_grid
    from pyannote_audio_tpu_torch.ops.fbank import fbank_num_frames
    emb = pipeline._embedding
    window = 10 * SAMPLE_RATE
    padded = pad_to_grid(waveform, window, SAMPLE_RATE)
    num_real = fbank_num_frames(waveform.shape[1])
    halo = pipeline.TRUNK_PANEL_HALO
    dtype = emb.compute_dtype
    try:
        for compute_dtype in (torch.float32, torch.bfloat16):
            emb.compute_dtype = compute_dtype
            trunk = pipeline.compute_trunk(padded, num_real, window)
            layout = pipeline.prepare(pipeline._whole_fbank(padded),
                                      num_real, window)
            whole = emb.frames_from_fbank(layout[None], centered=True)[0]
            total = -(-fbank_num_frames(padded.shape[1]) // 8)
            ours, ref = trunk[:total], whole[halo:halo + total]
            err = (ours - ref).abs().max().item()
            if compute_dtype == torch.float32:
                ok, limit = err <= PANEL_F32_ATOL, f"{PANEL_F32_ATOL}"
            else:
                ok = bool(((ours - ref).abs()
                           <= PANEL_BF16_ATOL
                           + PANEL_BF16_RTOL * ref.abs()).all())
                limit = f"atol {PANEL_BF16_ATOL} + rtol {PANEL_BF16_RTOL}"
            log(f"{label} panel trunk vs one pass, {compute_dtype}: "
                f"{tuple(ours.shape)} trunk frames, max_abs_err {err:.3e} "
                f"(scale {ref.abs().max().item():.3e}, limit {limit})")
            if not (ok and torch.isfinite(trunk).all()):
                raise AssertionError("the panelled trunk disagrees with "
                                     "one pass over the same layout")
    finally:
        emb.compute_dtype = dtype


def check_shared_trunk(pipeline, waveform: torch.Tensor) -> None:
    """(d) Shared-trunk (bf16) embeddings against the exact path's
    (per-chunk float32 trunk), on the same segmentation."""
    emb = pipeline._embedding
    segmentations = pipeline._segmentation.slide(waveform, SAMPLE_RATE)
    shared = pipeline.get_embeddings(waveform, segmentations)
    dtype = emb.compute_dtype
    os.environ["PYANNOTE_TPU_SHARED_TRUNK"] = "0"
    emb.compute_dtype = torch.float32
    try:
        exact = pipeline.get_embeddings(waveform, segmentations)
    finally:
        emb.compute_dtype = dtype
        set_gates(None)
    active = (segmentations.data.sum(dim=1) > 0).cpu().numpy()
    a, b = shared[active], exact[active]
    cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                   * np.linalg.norm(b, axis=1) + 1e-9)
    log(f"(d) shared-trunk bf16 vs exact float32 embeddings over "
        f"{len(cos)} active (chunk, speaker) pairs: cosine min "
        f"{cos.min():.4f} (limit > {SHARED_TRUNK_MIN_COS}), mean "
        f"{cos.mean():.4f} (limit > {SHARED_TRUNK_MEAN_COS})")
    if not (np.isfinite(shared).all() and cos.min() > SHARED_TRUNK_MIN_COS
            and cos.mean() > SHARED_TRUNK_MEAN_COS):
        raise AssertionError("shared-trunk embeddings are too far from the "
                             "exact path's")


def check_lstm_precision(pipeline, waveform: torch.Tensor) -> None:
    """(f) PyanNet log-probs with the LSTM at "default" (bf16 products)
    against "highest" (float32), the other gates at their defaults."""
    inference = pipeline._segmentation
    powerset, inference._powerset = inference._powerset, None
    try:
        with lstm_precision_env("highest"):
            exact = inference.slide(waveform, SAMPLE_RATE).data
        with lstm_precision_env("default"):
            bf16 = inference.slide(waveform, SAMPLE_RATE).data
    finally:
        inference._powerset = powerset
    err = (bf16 - exact).abs().max().item()
    flips = (bf16.argmax(-1) != exact.argmax(-1)).float().mean().item()
    log(f"(f) PyanNet log-probs, LSTM precision default vs highest on "
        f"{len(exact)} chunks: max_abs_err {err:.3e} (limit "
        f"{LSTM_DEFAULT_LOGP_ATOL}), powerset argmax flips at {flips:.4%} "
        f"of chunk frames")
    if not (torch.isfinite(bf16).all() and err <= LSTM_DEFAULT_LOGP_ATOL):
        raise AssertionError("the default LSTM precision is too far from "
                             "float32")


FBANK_ROUTES = {"cufft": {"PYANNOTE_TPU_CONV_FBANK": "0"},
                "conv": {"PYANNOTE_TPU_CONV_FBANK": "1"},
                "dft_matmul": {"PYANNOTE_TPU_CONV_FBANK": "0",
                               "PYANNOTE_TPU_DFT_FBANK": "1"}}


def fbank_float64(samples: np.ndarray) -> np.ndarray:
    """Kaldi log-mel fbank (hamming window) of a 1-D float array, in
    float64 on the host: the JAX package's golden recipe
    (tests/test_fbank.py), vectorized over frames."""
    from pyannote_audio_tpu_torch.ops.fbank import _window, kaldi_mel_banks
    frames = np.lib.stride_tricks.sliding_window_view(
        samples.astype(np.float64), 400)[::160]
    frames = frames - frames.mean(axis=-1, keepdims=True)
    frames = np.concatenate([frames[:, :1] * 0.03,
                             frames[:, 1:] - 0.97 * frames[:, :-1]], axis=-1)
    power = np.abs(np.fft.rfft(frames * _window("hamming", 400), n=512)) ** 2
    mel = power @ kaldi_mel_banks(80, 512, SAMPLE_RATE).astype(np.float64)
    return np.log(np.maximum(mel, 1.1920928955078125e-07))


def check_fbank_spectra(waveform: torch.Tensor) -> dict:
    """The fbank through each power spectrum (composed conv, DFT matmul,
    cuFFT's rfft): each held to the golden bound against a float64
    reference on 60 s of the golden input (white noise at 0.1); then the
    whole-file fbank of a (1, samples) waveform timed in turns, with each
    spectrum's distance from cuFFT's printed."""
    from pyannote_audio_tpu_torch.ops.fbank import whole_fbank
    noise = (0.1 * np.random.default_rng(3).standard_normal(
        (1, 60 * SAMPLE_RATE))).astype(np.float32)
    reference = fbank_float64(noise[0] * 32768.0)
    noise = torch.from_numpy(noise).to(waveform.device)
    feats, times = {}, {name: [] for name in FBANK_ROUTES}
    for name, values in FBANK_ROUTES.items():
        with environ(values):
            golden = whole_fbank(noise).cpu().numpy()
        err = np.abs(golden - reference).max()
        log(f"fbank spectrum {name}: {golden.shape} frames of the golden "
            f"input vs float64, max_abs_err {err:.3e} (limit "
            f"{FBANK_SPECTRA_ATOL})")
        if not (np.isfinite(golden).all() and err <= FBANK_SPECTRA_ATOL):
            raise AssertionError(f"the {name} fbank spectrum is off the "
                                 f"golden bound")
    for _ in range(2):                      # in turns, twice
        for name, values in FBANK_ROUTES.items():
            with environ(values):
                feats[name] = whole_fbank(waveform)
                times[name].append(cuda_ms(lambda: whole_fbank(waveform),
                                           runs=10))
    minutes = waveform.shape[1] / SAMPLE_RATE / 60
    log(f"whole-file fbank of {minutes:g} min, {tuple(feats['conv'].shape)}"
        f" frames, ms (median of 10, two rounds in turns): " + ", ".join(
            f"{name} {' / '.join('%.3f' % t for t in ts)}"
            for name, ts in times.items()))
    log("  distance from cuFFT's on this file (its near-silent stretches "
        "leave mel bins with little energy, where float32 sums of another "
        "order differ most): " + ", ".join(
            f"{name} {(feats[name] - feats['cufft']).abs().max().item():.3e}"
            for name in ("conv", "dft_matmul")))
    return times


def panel_batches(pipeline) -> int:
    """Trunk panel batches the files of FILE_MINUTES take."""
    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    from pyannote_audio_tpu_torch.ops.fbank import fbank_num_frames
    stride = pipeline.trunk_geometry(10 * SAMPLE_RATE)["stride"]
    total = 0
    for minutes in FILE_MINUTES:
        _, padded_len = _chunk_grid(int(minutes * 60 * SAMPLE_RATE),
                                    10 * SAMPLE_RATE, SAMPLE_RATE)
        total += pipeline._num_panel_batches(fbank_num_frames(padded_len),
                                             stride)
    return total


def phase_accelerator(device: torch.device, workdir: Path) -> tuple:
    """The accelerator path at its defaults; returns its pipeline (phase 6
    goes on with it) and the LSTM kernel's launch count on it."""
    set_gates(None)
    segmentation, embedding = make_models(torch.bfloat16)
    pipeline = build_pipeline(segmentation, embedding, device)
    files = write_files(workdir, FILE_MINUTES)
    short = torch.from_numpy(synth(FILE_MINUTES[1], seed=1)[None]).to(device)
    long = torch.from_numpy(synth(FILE_MINUTES[0], seed=0)[None]).to(device)
    with torch.inference_mode():
        check_shared_sinc(pipeline, short)
        check_shared_fbank(pipeline, short)
        check_panels(pipeline, long)
        check_shared_trunk(pipeline, short)
        check_lstm_precision(pipeline, short)
        check_fbank_spectra(long)
    del short, long

    batches = len(segmentation_batches())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(pipeline)
    outputs = pipeline([dict(f) for f in files], max_speakers=4)
    torch.cuda.synchronize()
    counts = read_counts(pipeline)
    peak = torch.cuda.max_memory_allocated(device)
    check_outputs(files, outputs)
    # 10 + 3 min: 7500 + 2250 trunk frames, panels of 512 in batches of 8
    expected = {"whole_conv": len(files), "whole_fbank": len(files),
                "trunk_panel_batches": panel_batches(pipeline),
                "chunk_trunk_batches": 0, "lstm_launches": 2 * batches}
    log(f"(e) accelerator path counts: {counts} (expected {expected}); "
        f"lstm_recurrence launches = 2 layers x {batches} segmentation "
        f"batches; peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if counts != expected:
        raise AssertionError("the accelerator path did not run as "
                             "expected (a per-chunk fallback?)")
    timed_passes(pipeline, files, sum(FILE_MINUTES), "accelerator path")
    return pipeline, counts["lstm_launches"]


def logprobs(pipeline, waveform: np.ndarray) -> torch.Tensor:
    """PyanNet's (C, F, 7) log-probabilities over a host waveform, in the
    slice plan that the environment sets."""
    inference = pipeline._segmentation
    powerset, inference._powerset = inference._powerset, None
    try:
        with torch.inference_mode():
            return inference.slide(waveform, SAMPLE_RATE, cache={}).data
    finally:
        inference._powerset = powerset


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1) + 1e-9)


def check_same_diarization(label: str, ours, theirs, logp_ours,
                           logp_theirs, frames) -> None:
    """Hold a traced run (``ours``: sliced) to another (``theirs``:
    whole-file) by the near-tie rule of the SLICED_* constants."""
    (out_a, a), (out_b, b) = ours, theirs
    err = (logp_ours - logp_theirs).abs().max().item()
    flips = logp_ours.argmax(-1) != logp_theirs.argmax(-1)      # (C, F)
    top = torch.topk(logp_theirs, 2, dim=-1).values
    margins = (top[..., 0] - top[..., 1])[flips]
    worst = margins.max().item() if margins.numel() else 0.0
    touched = flips.any(-1).cpu().numpy()
    num_flips = int(flips.sum().item())
    log(f"{label}: log-prob max_abs_err {err:.3e}; {num_flips} of "
        f"{flips.numel()} chunk frames flip their powerset class, largest "
        f"margin {worst:.3e} (limit {2 * err:.3e}, twice the error); "
        f"{int(touched.sum())} of {len(touched)} chunks touched")
    if worst > 2 * err:
        raise AssertionError(f"{label}: a powerset flip is not a near tie")
    differ = (a["scores"] != b["scores"]).any(axis=(1, 2))
    if differ[~touched].any():
        raise AssertionError(f"{label}: hard scores differ in chunks no "
                             f"flip touches")
    if not np.array_equal(a["clusters"][~touched], b["clusters"][~touched]):
        raise AssertionError(f"{label}: hard clusters differ outside the "
                             f"touched chunks")
    offsets, _, _ = output_offsets(a, frames)
    fed = set()
    for c in np.flatnonzero(touched):
        fed.update(range(int(offsets[c]), int(offsets[c])
                         + a["scores"].shape[1]))
    for name, x, y in zip(("normal", "exclusive"), a["binary"],
                          b["binary"]):
        rows = np.flatnonzero((x != y).any(-1)) if x.shape == y.shape \
            else None
        if rows is None or not set(rows.tolist()) <= fed:
            raise AssertionError(f"{label}: {name} reconstruction differs "
                                 f"beyond the frames touched chunks feed")
        log(f"  {name} reconstruction: {len(rows)} of {len(x)} output "
            f"frames differ, none beyond the touched chunks' frames")
    active = (a["scores"].sum(axis=1) > 0) & (b["scores"].sum(axis=1) > 0)
    active[touched] = False
    cos = cosines(a["embeddings"][active], b["embeddings"][active])
    log(f"  embeddings: cosine min {cos.min():.6f} over {len(cos)} active "
        f"(chunk, speaker) pairs of untouched chunks (limit > "
        f"{SLICED_EMBEDDING_MIN_COS})")
    if not (len(cos) and cos.min() > SLICED_EMBEDDING_MIN_COS):
        raise AssertionError(f"{label}: embeddings too far apart")
    ta = list(out_a.speaker_diarization.itertracks(yield_label=True))
    tb = list(out_b.speaker_diarization.itertracks(yield_label=True))
    same = len(ta) == len(tb) and all(
        la == lb and abs(sa.start - sb.start) <= SLICED_BOUNDARY_TOL
        and abs(sa.end - sb.end) <= SLICED_BOUNDARY_TOL
        for (sa, _, la), (sb, _, lb) in zip(ta, tb))
    log(f"  {len(ta)} vs {len(tb)} segments, labels "
        f"{out_a.speaker_diarization.labels()} vs "
        f"{out_b.speaker_diarization.labels()}; boundaries within "
        f"{SLICED_BOUNDARY_TOL} s: {same}")
    if not ta or (num_flips == 0 and not same):
        raise AssertionError(f"{label}: the Annotations differ")


def output_offsets(seen: dict, frames):
    """Per-chunk output-frame offsets of a traced run's chunk grid."""
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    return SpeakerDiarization._aggregation_grid(
        seen["window"], frames, len(seen["scores"]))


def peak_and_wall(device, fn):
    """(peak device memory in bytes, wall seconds) of ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    wall = wall_seconds(fn)
    return torch.cuda.max_memory_allocated(device), wall


def check_forced_slices(pipeline, waveform: np.ndarray) -> None:
    """(g) The 10-minute file in forced 3-minute slices against whole-file
    buffers."""
    file = {"waveform": waveform, "sample_rate": SAMPLE_RATE,
            "uri": "ten_minutes"}
    frames = pipeline._segmentation.model.receptive_field
    with environ({"PYANNOTE_TPU_SEGMENT_MINUTES": "0"}):
        whole = traced_run(pipeline, file)
        logp_whole = logprobs(pipeline, waveform)
    with environ({"PYANNOTE_TPU_SEGMENT_MINUTES": FORCED_SLICE_MINUTES}):
        plan = pipeline._plan(waveform.shape[1])
        reset_counts(pipeline)
        sliced = traced_run(pipeline, file)
        counts = read_counts(pipeline)
        logp_sliced = logprobs(pipeline, waveform)
    log(f"(g) 10 min in {FORCED_SLICE_MINUTES}-minute slices: "
        f"{[(sl.a, sl.b, sl.i0, sl.i1) for sl in plan]}; counts {counts}")
    if plan is None or counts["whole_conv"] != len(plan) or \
            counts["whole_fbank"] != len(plan):
        raise AssertionError("(g) the slice plan did not run")
    check_same_diarization("(g) sliced vs whole", sliced, whole,
                           logp_sliced, logp_whole, frames)


def check_long_file(pipeline, device) -> dict:
    """(h) A 150-minute file under the automatic slice plan against the
    same file forced whole: plan, peaks, walls and results."""
    waveform = synth(LONG_MINUTES, seed=5)[None]
    file = {"waveform": waveform, "sample_rate": SAMPLE_RATE,
            "uri": "long"}
    frames = pipeline._segmentation.model.receptive_field
    runs = {}
    for label, minutes in (("sliced (auto)", None), ("whole", "0")):
        with environ({"PYANNOTE_TPU_SEGMENT_MINUTES": minutes}):
            plan = pipeline._plan(waveform.shape[1])
            pipeline(dict(file), max_speakers=4)              # warm
            peak, wall = peak_and_wall(
                device, lambda: pipeline(dict(file), max_speakers=4))
            runs[label] = {"plan": plan, "peak": peak, "wall": wall,
                           "traced": traced_run(pipeline, file),
                           "logp": logprobs(pipeline, waveform)}
        log(f"(h) {LONG_MINUTES:g} min, {label}: plan "
            f"{None if plan is None else [(s.a, s.b, s.i0, s.i1) for s in plan]}"
            f"; peak device memory {peak / 2**30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated), wall {wall:.3f} s = "
            f"{wall * 60.0 / LONG_MINUTES:.3f} s per audio-hour")
    sliced, whole = runs["sliced (auto)"], runs["whole"]
    got = [(s.a, s.b, s.i0, s.i1) for s in sliced["plan"] or []]
    if got != LONG_PLAN or whole["plan"] is not None:
        raise AssertionError(f"(h) slice plan {got} != {LONG_PLAN}")
    from pyannote_audio_tpu_torch.utils.flops import \
        diarization_resident_hbm_bytes as modelled
    longest = max(s.b - s.a for s in sliced["plan"]) / SAMPLE_RATE
    log(f"(h) peak sliced {sliced['peak'] / 2**30:.3f} GiB vs whole "
        f"{whole['peak'] / 2**30:.3f} GiB (limit: lower); modelled by "
        f"utils/flops.py diarization_resident_hbm_bytes: largest slice "
        f"({longest / 60:.1f} min) "
        f"{modelled(longest)['total'] / 2**30:.3f} GiB, whole "
        f"{modelled(LONG_MINUTES * 60)['total'] / 2**30:.3f} GiB")
    if not sliced["peak"] < whole["peak"]:
        raise AssertionError("(h) slicing did not lower the peak")
    check_same_diarization("(h) sliced vs whole", sliced["traced"],
                           whole["traced"], sliced["logp"], whole["logp"],
                           frames)
    return {k: {"peak": v["peak"], "wall": v["wall"]}
            for k, v in runs.items()}


# host seconds read from a span recording (``telemetry/spans.py``): the
# name each is printed under and the span path it sums
RECORDED_SPANS = (("stage", "stage"), ("finalize", "finalize"),
                  ("wait", "finalize/staged_wait"),
                  ("reconstruct_wait",
                   "finalize/reconstruct/reconstruct_wait"),
                  ("clustering", "finalize/clustering"))


def recorded_seconds(recording) -> dict:
    """Host seconds in ``_stage``, in ``_finalize``, and inside it waiting
    for the staged copies and for the reconstruction, and clustering,
    from the pipeline's own spans (nothing synchronised)."""
    totals = recording.totals()
    return {name: totals.get(path, 0.0) for name, path in RECORDED_SPANS}


@contextlib.contextmanager
def reconstruction_stream(pipeline, on: bool):
    """With ``on``, ``_finalize``'s reconstruction runs on a second CUDA
    stream, ordered after the file's staged copies by their event: the
    variant measured beside the one stream the pipeline uses, where the
    reconstruction queues behind the files staged after it."""
    if not on:
        yield
        return
    stream = torch.cuda.Stream()
    reconstruct = pipeline._reconstruct

    def on_side_stream(staged, *args):
        stream.wait_event(staged["event"])
        with torch.cuda.stream(stream):
            return reconstruct(staged, *args)
    pipeline._reconstruct = on_side_stream
    try:
        yield
    finally:
        del pipeline._reconstruct


def check_batch(pipeline, device, workdir: Path) -> dict:
    """(i) apply_batch on the serving mix against apply file by file."""
    from pyannote_audio_tpu_torch.pipelines.utils.hook import TimingHook
    from pyannote_audio_tpu_torch.telemetry import spans
    files = write_files(workdir, SERVING_MINUTES)
    minutes = sum(SERVING_MINUTES)
    results, walls, peaks, counts = {}, {}, {}, {}
    modes = (("file by file", False, run_one_by_one),
             ("apply_batch, one stream", False, run_batch),
             ("apply_batch, reconstruction stream", True, run_batch))
    for label, side, run in modes:
        def call(label=label, run=run):
            results[label] = run(pipeline, files)
        with reconstruction_stream(pipeline, side):
            reset_counts(pipeline)
            peak, wall = peak_and_wall(device, call)
        counts[label] = read_counts(pipeline)
        walls.setdefault(label, []).append(wall)
        peaks[label] = peak
    for label, _, _ in modes:
        log(f"(i) {label}: {minutes:g} min in "
            f"{' / '.join('%.3f' % w for w in walls[label])} s = "
            f"{' / '.join('%.3f' % (w * 60 / minutes) for w in walls[label])}"
            f" s per audio-hour; peak {peaks[label] / 2**30:.3f} GiB; "
            f"counts {counts[label]}")
    reference = results["file by file"]
    for label, _, _ in modes[1:]:
        if counts[label] != counts["file by file"]:
            raise AssertionError(f"(i) {label} ran other work than file "
                                 f"by file: {counts[label]}")
        for f, x, y in zip(files, results[label], reference):
            if not (x.speaker_diarization == y.speaker_diarization
                    and x.exclusive_speaker_diarization
                    == y.exclusive_speaker_diarization
                    and np.array_equal(x.speaker_embeddings,
                                       y.speaker_embeddings)):
                raise AssertionError(f"(i) {label} differs from apply on "
                                     f"{f['uri']}")
    check_outputs(files, reference)
    log("(i) apply_batch's Annotations and centroids equal apply's on "
        "every file, in both stream modes")
    dicts = [dict(f) for f in files]
    with spans.recording() as recording, TimingHook() as timing:
        wall = wall_seconds(lambda: pipeline(dicts, max_speakers=4,
                                             hook=timing))
    seconds = recorded_seconds(recording)
    log(f"(i) apply_batch host time: _stage {seconds['stage']:.3f} s, "
        f"_finalize {seconds['finalize']:.3f} s (of which waiting for the "
        f"staged copies {seconds['wait']:.3f} s and for the "
        f"reconstruction {seconds['reconstruct_wait']:.3f} s), in a "
        f"{wall:.3f} s pass")
    if not all("segmentation" in f.get("timing", {}) for f in dicts):
        raise AssertionError("(i) TimingHook lost a file")
    log(f"(i) TimingHook through apply_batch: {dicts[-1]['timing']}")
    return {"walls": walls, "peaks": peaks, "host": seconds}


def check_no_sync(pipeline, path: str) -> None:
    """(j) ``_stage`` queues a file's device program without a
    synchronizing call, whole and in slices."""
    for label, minutes in (("whole", "0"), ("in 1-minute slices", "1")):
        with environ({"PYANNOTE_TPU_SEGMENT_MINUTES": minutes}):
            file = {"audio": path, "uri": "sync_debug"}
            pipeline._decode_into(file, False)
            pipeline._finalize(pipeline._stage(file, max_speakers=4))
            file = {"audio": path, "uri": "sync_debug"}
            pipeline._decode_into(file, False)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                staged = pipeline._stage(file, max_speakers=4)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out = pipeline._finalize(staged)
        log(f"(j) _stage of the 3-minute file {label} under "
            f"set_sync_debug_mode(\"error\"): no synchronizing call; "
            f"{len(out.speaker_diarization)} segments")


def phase_serving(pipeline, device, workdir: Path) -> None:
    """Phase 6: long files in slices, apply_batch, and staging without a
    host sync, at the accelerator path's defaults."""
    set_gates(None)
    check_forced_slices(pipeline, synth(FILE_MINUTES[0], seed=0)[None])
    check_long_file(pipeline, device)
    check_batch(pipeline, device, workdir)
    check_no_sync(pipeline, write_files(workdir, FILE_MINUTES)[1]["audio"])


# -- phase 7 ------------------------------------------------------------------

# the modules that pin float32 at their sites, and the names they import
PINNED_SITES = (("pyannote_audio_tpu_torch.models.blocks.rnn",
                 "exact_float32"),
                ("pyannote_audio_tpu_torch.ops.lstm", "exact_float32"),
                ("pyannote_audio_tpu_torch.ops.fbank", "exact_float32"),
                ("pyannote_audio_tpu_torch.models.blocks.sincnet",
                 "exact_float32_if"),
                ("pyannote_audio_tpu_torch.models.embedding.wespeaker",
                 "exact_float32_if"))


@contextlib.contextmanager
def pinning_lifted():
    """The port's float32 pinning replaced by a no-op at every site: the
    exact path as it ran before the sites were pinned (a measurement
    only)."""
    import importlib
    saved = []
    for module_name, name in PINNED_SITES:
        module = importlib.import_module(module_name)
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, lambda *args: contextlib.nullcontext())
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def phase_default_flags(device: torch.device) -> None:
    """(k) The exact path with torch's TF32 flags at their defaults, after
    ``torch.set_float32_matmul_precision("high")`` as a process that wants
    TF32 elsewhere sets it, held to the CPU; then the same with the
    pinning lifted, printed as a measurement."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("high")
    try:
        with lstm_precision_env("highest"):
            set_gates("0")
            segmentation, embedding = make_models(torch.float32)
            cpu_pipeline = build_pipeline(copy.deepcopy(segmentation),
                                          copy.deepcopy(embedding), "cpu")
            pipeline = build_pipeline(segmentation, embedding, device)
            wav = synth(0.5, seed=7)[None]
            log(f"(k) TF32 flags: cudnn.allow_tf32 "
                f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
                f"{torch.backends.cuda.matmul.allow_tf32} "
                f"(set_float32_matmul_precision(\"high\"))")
            card_vs_cpu(pipeline, cpu_pipeline, device, wav,
                        "(k) exact path under TF32-on flags vs CPU")
            after = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            if after != (True, True):
                raise AssertionError(f"(k) the pinned sites left the flags "
                                     f"at {after}")
            with pinning_lifted():
                card_vs_cpu(pipeline, cpu_pipeline, device, wav,
                            "(k) measurement, pinning lifted (TF32 on)",
                            check=False)
    finally:
        torch.set_float32_matmul_precision("highest")
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
        set_gates(None)


PLDA_DIM, PLDA_LDA_DIM = 256, 128
COMMUNITY_PARAMS = {"segmentation": {"min_duration_off": 0.0},
                    "clustering": {"threshold": 0.6, "Fa": 0.07,
                                   "Fb": 0.8}}
# the device VBx EM (float32, 20 iterations) against the host one
# (float64, early stop): responsibilities, priors and centroids within
# 1e-4 (the CPU tests' bound, tests/test_torch_port_vbx.py), the same
# speakers kept and the same VBx hard clusters (gamma's argmax). The
# pipeline's per-chunk Hungarian assignment may differ only where two
# assignments tie within 1e-4 of summed scores: the float32 centroids
# move the scores by about 1e-7, which decides such ties
DEVICE_VBX_ATOL = 1e-4
# an AHC cut that splits these random-weight embeddings (centroid-linkage
# merges span about 0.01-0.13) into many clusters, for VBx to merge
VBX_SPLIT_THRESHOLD = 0.05


def write_community_snapshot(root: Path) -> dict:
    """A community-1 style snapshot: full-width PyanNet and ResNet34
    reference checkpoints (make_models' seeded weights, bf16 trunk), a
    seeded synthetic PLDA 256 -> 128 (psi > 0) and its ``config.yaml``
    (written by the port's YAML writer: the card machine has no PyYAML);
    returns the config as the dict that ``Pipeline.from_pretrained`` also
    takes."""
    from pyannote_audio_tpu_torch.utils import yaml_subset
    from pyannote_audio_tpu_torch.utils.convert import \
        write_reference_checkpoint
    segmentation, embedding = make_models(torch.bfloat16)
    write_reference_checkpoint(segmentation.state_dict(), "PyanNet",
                               segmentation.reference_hparams(),
                               segmentation.specifications,
                               root / "segmentation")
    write_reference_checkpoint(embedding.state_dict(), "WeSpeakerResNet34",
                               embedding.reference_hparams(), None,
                               root / "embedding")
    rng = np.random.default_rng(0)
    (root / "plda").mkdir(parents=True)
    np.savez(root / "plda" / "xvec_transform.npz",
             mean1=rng.standard_normal(PLDA_DIM) * 0.01,
             mean2=rng.standard_normal(PLDA_LDA_DIM) * 0.01,
             lda=rng.standard_normal((PLDA_DIM, PLDA_LDA_DIM)) * 0.1)
    np.savez(root / "plda" / "plda.npz",
             mu=rng.standard_normal(PLDA_LDA_DIM) * 0.01,
             tr=np.linalg.qr(rng.standard_normal((PLDA_LDA_DIM,
                                                  PLDA_LDA_DIM)))[0],
             psi=np.abs(rng.standard_normal(PLDA_LDA_DIM)) + 0.5)
    config = {"version": "4.0.0",
              "pipeline": {"name": "pyannote.audio.pipelines."
                                   "SpeakerDiarization",
                           "params": {"clustering": "VBxClustering",
                                      "embedding": "$model/embedding",
                                      "embedding_batch_size": BATCH_SIZE,
                                      "embedding_exclude_overlap": True,
                                      "plda": "$model/plda",
                                      "segmentation": "$model/segmentation",
                                      "segmentation_batch_size": BATCH_SIZE}},
              "params": COMMUNITY_PARAMS}
    yaml_subset.dump_file(config, root / "config.yaml")
    return dict(config, checkpoint=str(root))


@contextlib.contextmanager
def clustering_inputs(pipeline, inputs: list):
    """Each call of ``pipeline.clustering``'s arguments and result, kept
    in ``inputs`` (its host seconds are the ``finalize/clustering`` span's,
    ``recorded_seconds``)."""
    clustering = pipeline.clustering

    def kept(*args, **kwargs):
        out = clustering(*args, **kwargs)
        inputs.append((args, kwargs, out))
        return out
    pipeline.clustering = kept
    try:
        yield inputs
    finally:
        pipeline.clustering = clustering


def serving_pass(pipeline, files: list) -> dict:
    """One ``apply_batch`` pass with host seconds in ``_stage``,
    ``_finalize`` and clustering, from the pipeline's spans."""
    from pyannote_audio_tpu_torch.telemetry import spans
    with spans.recording() as recording:
        wall = wall_seconds(lambda: run_batch(pipeline, files))
    return dict(recorded_seconds(recording), wall=wall)


def vbx_init(clustering, embeddings, clean_frames, num_frames):
    """What VBxClustering hands the EM: the AHC initialization and the
    PLDA latent features of the kept embeddings."""
    from scipy.cluster.hierarchy import fcluster, linkage
    train, _, _ = clustering.filter_embeddings(embeddings, clean_frames,
                                               num_frames)
    normed = train / np.linalg.norm(train, axis=1, keepdims=True)
    ahc = fcluster(linkage(normed, method="centroid", metric="euclidean"),
                   clustering.threshold, criterion="distance") - 1
    return np.unique(ahc, return_inverse=True)[1], clustering.plda(train), \
        normed


def near_tie_gaps(soft: np.ndarray, hard: np.ndarray,
                  other: np.ndarray) -> list:
    """For each chunk whose per-chunk assignment ``other`` differs from
    ``hard``: how much lower ``other`` scores under ``soft`` (the sum of
    each assigned local speaker's score), i.e. how far from a tie."""
    def score(c, assignment):
        return sum(soft[c, s, k] for s, k in enumerate(assignment) if k >= 0)
    return [score(c, hard[c]) - score(c, other[c])
            for c in np.flatnonzero((hard != other).any(axis=1))]


def check_device_clustering(pipeline, inputs, device) -> None:
    """The device VBx EM and KMeans against their host versions on the
    embeddings one file staged: at the config's AHC threshold and at
    VBX_SPLIT_THRESHOLD, where the AHC initialization has many clusters
    for VBx to merge."""
    from pyannote_audio_tpu_torch.ops.kmeans import kmeans
    from pyannote_audio_tpu_torch.utils.vbx import cluster_vbx
    clustering = pipeline.clustering
    (embeddings, clean_frames), kwargs, host_out = inputs
    threshold = clustering.threshold
    for split in (threshold, VBX_SPLIT_THRESHOLD):
        clustering.threshold = split
        try:
            ahc, latent, normed = vbx_init(clustering, embeddings,
                                           clean_frames,
                                           kwargs["num_frames"])
            runs = {}
            for gate in ("0", "1"):
                with environ({"PYANNOTE_TPU_DEVICE_VBX": gate}):
                    start = time.perf_counter()
                    runs[gate] = cluster_vbx(
                        ahc, latent, clustering.plda.phi, fa=clustering.Fa,
                        fb=clustering.Fb, max_iters=20, device=device)
                    runs[gate + "s"] = time.perf_counter() - start
                    runs[gate + "out"] = clustering(embeddings, clean_frames,
                                                    **kwargs)
        finally:
            clustering.threshold = threshold
        gamma_err = np.abs(runs["1"][0] - runs["0"][0]).max()
        pi_err = np.abs(runs["1"][1] - runs["0"][1]).max()
        kept = [int((runs[g][1] > 1e-7).sum()) for g in ("0", "1")]
        same_vbx = np.array_equal(runs["1"][0].argmax(1),
                                  runs["0"][0].argmax(1))
        (hard, soft, centroids), (hard_dev, _, centroids_dev) = \
            runs["0out"], runs["1out"]
        if split == threshold and not np.array_equal(hard, host_out[0]):
            raise AssertionError("(l) VBx clustering is not reproducible")
        gaps = near_tie_gaps(soft, hard, hard_dev)
        centroid_err = np.abs(centroids_dev - centroids).max() \
            if centroids.shape == centroids_dev.shape else np.inf
        log(f"(l) device VBx EM (float32, 20 iterations) vs host (float64) "
            f"at AHC threshold {split} on {latent.shape} latent features "
            f"from {len(np.unique(ahc))} AHC clusters to {kept[0]} (host) / "
            f"{kept[1]} (device) speakers: gamma max_abs_err "
            f"{gamma_err:.3e}, pi {pi_err:.3e} (limit {DEVICE_VBX_ATOL}); "
            f"VBx hard clusters (gamma argmax) equal: {same_vbx}; centroids "
            f"max_abs_err {centroid_err:.3e}; pipeline hard clusters differ "
            f"in {len(gaps)} of {len(hard)} chunks, each at a near tie of "
            f"the per-chunk assignment (score gap {max(gaps, default=0):.3e},"
            f" limit {DEVICE_VBX_ATOL}); host {runs['0s'] * 1e3:.1f} ms, "
            f"device {runs['1s'] * 1e3:.1f} ms")
        if not (gamma_err <= DEVICE_VBX_ATOL and pi_err <= DEVICE_VBX_ATOL
                and same_vbx and kept[0] == kept[1]
                and centroid_err <= DEVICE_VBX_ATOL
                and max(gaps, default=0.0) <= DEVICE_VBX_ATOL):
            raise AssertionError("(l) the device VBx disagrees with the "
                                 "host's")
    for k in (2, 3, 4):
        start = time.perf_counter()
        host = kmeans(normed, k, device="cpu")
        host_s = time.perf_counter() - start
        start = time.perf_counter()
        on_card = kmeans(normed, k, device=device)
        card_s = time.perf_counter() - start
        pairs = set(zip(host.tolist(), on_card.tolist()))
        same = len(pairs) == len({a for a, _ in pairs}) == \
            len({b for _, b in pairs})
        log(f"(l) KMeans k={k} on {normed.shape}: card partition equals the "
            f"CPU's: {same}; CPU {host_s * 1e3:.1f} ms, card "
            f"{card_s * 1e3:.1f} ms")
        if not same:
            raise AssertionError("(l) the device KMeans disagrees with the "
                                 "CPU's")
    with environ({"PYANNOTE_TPU_DEVICE_KMEANS": "1"}):
        out = clustering(embeddings, clean_frames,
                         **dict(kwargs, num_clusters=2))
    with environ({"PYANNOTE_TPU_DEVICE_KMEANS": "0"}):
        ref = clustering(embeddings, clean_frames,
                         **dict(kwargs, num_clusters=2))
    pairs = set(zip(out[0].ravel().tolist(), ref[0].ravel().tolist()))
    if not len(pairs) == len({a for a, _ in pairs}) == \
            len({b for _, b in pairs}):
        raise AssertionError("(l) VBx's KMeans fallback on the card "
                             "disagrees with the CPU's")
    log("(l) VBx with num_clusters=2 (KMeans fallback), "
        "PYANNOTE_TPU_DEVICE_KMEANS=1 vs 0: the same hard clusters up to "
        "relabelling")


def synthetic_annotation(minutes: float, seed: int, uri: str):
    """The speech turns ``synth`` renders, labelled by pitch."""
    from pyannote_audio_tpu_torch.core.annotation import Annotation
    from pyannote_audio_tpu_torch.core.segment import Segment
    names = {140.0: "low", 210.0: "mid", 320.0: "high"}
    annotation = Annotation(uri=uri)
    for i, start in enumerate(np.arange(0.0, minutes * 60 - 5.0, 7.0)):
        f0 = [140.0, 210.0, 320.0][(i + seed) % 3]
        annotation[Segment(float(start), float(start) + 5.0)] = names[f0]
    return annotation


def on_card(pipeline) -> bool:
    """Are the pipeline's models and its clustering's device on the
    card?"""
    return (pipeline._embedding.resnet.conv1.weight.is_cuda
            and next(pipeline._segmentation.model.parameters()).is_cuda
            and torch.device(pipeline.clustering.device).type == "cuda")


def phase_community(device: torch.device, workdir: Path,
                    ahc_pipeline) -> tuple:
    """(l) The community-1 shape on the card; returns its LSTM launches
    and the snapshot's config dict."""
    from pyannote_audio_tpu_torch import Pipeline
    from pyannote_audio_tpu_torch.pipelines.clustering import VBxClustering
    set_gates(None)
    config = write_community_snapshot(workdir / "community")
    start = time.perf_counter()
    pipeline = Pipeline.from_pretrained(config, device="cpu").to("cuda")
    log(f"(l) Pipeline.from_pretrained(config dict, device=\"cpu\")"
        f".to(\"cuda\") in {time.perf_counter() - start:.3f} s: "
        f"{type(pipeline).__name__} with {type(pipeline.clustering).__name__}"
        f", params {pipeline.parameters(instantiated=True)}")
    if not (isinstance(pipeline.clustering, VBxClustering)
            and on_card(pipeline)):
        raise AssertionError("(l) the snapshot did not load onto the card")

    files = write_files(workdir, FILE_MINUTES)
    run_batch(pipeline, files)                                  # warm
    torch.cuda.synchronize()
    reset_counts(pipeline)
    inputs = []
    with clustering_inputs(pipeline, inputs):
        batch = run_batch(pipeline, files)
    torch.cuda.synchronize()
    counts = read_counts(pipeline)
    one_by_one = run_one_by_one(pipeline, files)
    check_outputs(files, batch)
    log(f"(l) 10 + 3 min through apply_batch, counts {counts}")
    if counts["lstm_launches"] <= 0:
        raise AssertionError("(l) the LSTM kernel did not run on the "
                             "community-1 path")
    for f, x, y in zip(files, batch, one_by_one):
        if not (x.speaker_diarization == y.speaker_diarization
                and np.array_equal(x.speaker_embeddings,
                                   y.speaker_embeddings)):
            raise AssertionError(f"(l) apply_batch differs from apply on "
                                 f"{f['uri']}")
    timed_passes(pipeline, files, sum(FILE_MINUTES), "(l) community-1 VBx")

    serving = write_files(workdir, SERVING_MINUTES)
    passes = {}
    for label, p in (("VBx", pipeline), ("AHC", ahc_pipeline)):
        run_batch(p, serving[-2:])                              # warm
        passes[label] = [serving_pass(p, serving) for _ in range(2)]
    for label, runs in passes.items():
        log(f"(l) serving list {sum(SERVING_MINUTES):g} min through "
            f"apply_batch, {label}: " + "; ".join(
                f"wall {r['wall']:.3f} s, _stage {r['stage']:.3f} s, "
                f"_finalize {r['finalize']:.3f} s (clustering "
                f"{r['clustering']:.3f} s)" for r in runs))

    file = dict(files[1])
    calls = []
    kmeans_of = pipeline.clustering._kmeans
    pipeline.clustering._kmeans = \
        lambda *args: calls.append(1) or kmeans_of(*args)
    try:
        two = pipeline(dict(file), num_speakers=2)
    finally:
        del pipeline.clustering._kmeans
    labels = two.speaker_diarization.labels()
    log(f"(l) num_speakers=2 on {file['uri']}: labels {labels}, KMeans "
        f"fallback runs {len(calls)}")
    if len(labels) != 2 or two.speaker_embeddings.shape != (2, 256) or \
            len(calls) != 1:
        raise AssertionError("(l) num_speakers=2 did not take the KMeans "
                             "fallback to 2 speakers")

    annotation = synthetic_annotation(FILE_MINUTES[1], seed=1,
                                      uri=file["uri"])
    mapped = pipeline(dict(file, annotation=annotation))
    metric = pipeline.get_metric()
    der = metric(annotation, mapped.speaker_diarization)
    shared = set(mapped.speaker_diarization.labels()) & set(
        annotation.labels())
    log(f"(l) label mapping onto a synthetic annotation "
        f"{annotation.labels()}: labels {mapped.speaker_diarization.labels()}"
        f", greedy DER {der:.4f} (random weights)")
    if not shared or not np.isfinite(der):
        raise AssertionError("(l) no label was mapped onto the annotation")

    check_device_clustering(pipeline, inputs[0], device)
    return counts["lstm_launches"], config


# -- phase 8 ------------------------------------------------------------------

# (n): the shape of pyannote/segmentation 2.x, a sigmoid head over 3
# speakers on 5 s chunks after 4 BiLSTM layers of 128. Torch's init leaves
# a random 4-layer BiLSTM's output almost constant in time (each class's
# logit spreads by about 4e-4 over 30 s of synth audio), so the BiLSTM and
# linear weights are drawn at 3x its bound, and the head is centred on
# each class's median logit over that audio and scaled to a spread of 1.5:
# every class then crosses its threshold as the audio moves
ML_CLASSES = ("speaker#1", "speaker#2", "speaker#3")
ML_CHUNK_SECONDS = 5.0
ML_LSTM_LAYERS = 4
ML_WEIGHT_SCALE = 3.0
ML_LOGIT_SPREAD = 1.5
ML_THRESHOLD = 0.5
ML_PARAMS = {"thresholds": {c: {"onset": ML_THRESHOLD,
                                "offset": ML_THRESHOLD,
                                "min_duration_on": 0.0,
                                "min_duration_off": 0.0}
                            for c in ML_CLASSES}}
NON_POWERSET_PARAMS = {"segmentation": {"threshold": ML_THRESHOLD,
                                        "min_duration_off": 0.0},
                       "clustering": PARAMS["clustering"]}
VAD_PARAMS = {"min_duration_on": 0.0, "min_duration_off": 0.0}
# card against CPU: a binarized frame may differ only where the CPU's
# score lies within the bf16 SincNet bound of the threshold, or (VAD on a
# powerset model) where a near-tie powerset flip feeds the frame
NEAR_THRESHOLD = BF16_SINC_ATOL
# (o): the high-rate files; the batch decoder against one-by-one decode
# (tests/test_torch_port_io.py's resampling bound)
AUDIO_MINUTES = 10.0
PREDECODE_ATOL = 1e-6
# (p): device linkage against scipy's (tests/test_ahc.py's bounds on the
# sorted heights); the merge sequences may part only at a near tie (both
# heights within AHC_TIE), and only then may the partitions differ
AHC_HEIGHT_RTOL, AHC_HEIGHT_ATOL = 5e-3, 5e-4
AHC_TIE = 1e-4
# (q): float32 index_add_ sums in another order on the card
AGGREGATE_ATOL = 1e-5


def reset_lstm() -> None:
    """Both LSTM kernels' launch counts to 0."""
    from pyannote_audio_tpu_torch.ops.lstm_kernel import (
        lstm_bidirectional_recurrence, lstm_recurrence_backward)
    lstm_bidirectional_recurrence.launches = 0
    lstm_recurrence_backward.launches = 0


def lstm_launches() -> int:
    """The forward kernel's launches since ``reset_lstm``."""
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    return lstm_bidirectional_recurrence.launches


def backward_launches() -> int:
    """The backward kernel's launches since ``reset_lstm``."""
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_recurrence_backward
    return lstm_recurrence_backward.launches


def make_multilabel_model() -> torch.nn.Module:
    """(n)'s PyanNet: published widths (sinc stride 10, BiLSTM 4 x 128, 2 x
    Linear 128), a sigmoid head over ML_CLASSES, seeded weights scaled and
    the head calibrated as ML_WEIGHT_SCALE's comment says (on the CPU)."""
    from pyannote_audio_tpu_torch.core.inference import chunk_views
    from pyannote_audio_tpu_torch.core.model import Problem, Specifications
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    spec = Specifications(duration=ML_CHUNK_SECONDS, classes=list(ML_CLASSES),
                          problem=Problem.MULTI_LABEL_CLASSIFICATION)
    model = PyanNet(spec, lstm_layers=ML_LSTM_LAYERS,
                    generator=torch.Generator().manual_seed(3)).eval()
    window = int(ML_CHUNK_SECONDS * SAMPLE_RATE)
    chunks = chunk_views(torch.from_numpy(synth(0.5, seed=7)[None]), window,
                         window // 10).contiguous()
    with torch.no_grad():
        for name, p in model.lstm.named_parameters():
            if name.startswith("weight"):
                p.mul_(ML_WEIGHT_SCALE)
        for layer in model.linear:
            layer.weight.mul_(ML_WEIGHT_SCALE)
        logit = torch.logit(model(chunks).flatten(0, 1).double())
        gain = ML_LOGIT_SPREAD / logit.std(0)
        median = logit.median(0).values
        model.classifier.weight.mul_(gain[:, None].float())
        model.classifier.bias.sub_(median.float()).mul_(gain.float())
    return model


def short_file() -> dict:
    return {"waveform": synth(0.5, seed=7)[None], "sample_rate": SAMPLE_RATE,
            "uri": "short"}


def binarized_frames(label: str, ours: np.ndarray, theirs: np.ndarray,
                     threshold: float, allowed: np.ndarray = None
                     ) -> np.ndarray:
    """Hold the card's (frames, ...) scores ``ours`` to the CPU's
    ``theirs`` at ``threshold``: every frame binarized otherwise must lie
    within NEAR_THRESHOLD of it on the CPU, or be ``allowed``. Returns the
    mask of differing frames."""
    differ = (ours > threshold) != (theirs > threshold)
    near = np.abs(theirs - threshold) <= NEAR_THRESHOLD
    if allowed is not None:
        near = near | allowed.reshape(allowed.shape + (1,) * (
            near.ndim - allowed.ndim))
    err = np.abs(ours - theirs).max()
    log(f"{label}: scores max_abs_err {err:.3e}; {int(differ.sum())} of "
        f"{differ.size} binarized values differ at threshold {threshold}, "
        f"{int((differ & ~near).sum())} of them farther than "
        f"{NEAR_THRESHOLD} from it on the CPU (limit 0)"
        + ("" if allowed is None else
           f" and fed by no near-tie powerset flip"))
    if not np.isfinite(ours).all() or (differ & ~near).any():
        raise AssertionError(f"{label}: the card binarizes frames "
                             f"otherwise than the CPU away from the "
                             f"threshold")
    return differ


def powerset_flips(label: str, model_gpu, model_cpu, device,
                   waveform: np.ndarray, duration: float, step: float):
    """Chunk frames whose powerset argmax differs between the card and the
    CPU (each must be a near tie: its CPU margin within twice the log-prob
    error), and the chunk window."""
    from pyannote_audio_tpu_torch.core.inference import Inference
    logp = {}
    for name, model, dev in (("card", model_gpu, device),
                             ("cpu", model_cpu, "cpu")):
        inference = Inference(model, duration=duration, step=step,
                              batch_size=BATCH_SIZE, skip_aggregation=True,
                              skip_conversion=True, device=dev)
        with torch.inference_mode():
            out = inference.slide(waveform, SAMPLE_RATE, cache={})
        logp[name] = out.data.float().cpu()
    flips = hold_powerset(label, logp["card"], logp["cpu"])
    return flips, out.sliding_window, len(logp["cpu"])


def hold_powerset(label: str, logp_card: torch.Tensor,
                  logp_cpu: torch.Tensor) -> np.ndarray:
    """Every powerset flip between the card's and the CPU's (chunks,
    frames, classes) log-probs must be a near tie: its CPU margin within
    twice the log-prob error. Returns the flipped (chunk, frame) pairs."""
    err = (logp_card - logp_cpu).abs().max().item()
    top_card, top_cpu = logp_card.argmax(-1), logp_cpu.argmax(-1)
    flips = np.argwhere((top_card != top_cpu).numpy())
    margins = [(logp_cpu[c, f, top_cpu[c, f]]
                - logp_cpu[c, f, top_card[c, f]]).item() for c, f in flips]
    log(f"{label}: log-prob max_abs_err {err:.3e}; {len(flips)} of "
        f"{top_cpu.numel()} chunk frames flip their powerset class, largest "
        f"CPU margin {max(margins, default=0.0):.3e} (limit {2 * err:.3e})")
    if not torch.isfinite(logp_card).all() or \
            max(margins, default=0.0) > 2 * err:
        raise AssertionError(f"{label}: a powerset flip is not a near tie")
    return flips


def vad_config(config: dict) -> dict:
    """VoiceActivityDetection over the community-1 snapshot's
    segmentation model, as a config dict."""
    return {"checkpoint": config["checkpoint"], "version": config["version"],
            "pipeline": {"name": "pyannote.audio.pipelines."
                                 "VoiceActivityDetection",
                         "params": {"segmentation": "$model/segmentation",
                                    "batch_size": BATCH_SIZE}},
            "params": VAD_PARAMS}


def check_vad(device, workdir: Path, config: dict) -> int:
    """(m) VoiceActivityDetection loaded by ``Pipeline.from_pretrained``
    from a config dict over the community-1 snapshot: the card against
    the CPU on 30 s, then 10 + 3 min on the card; returns its LSTM
    launches."""
    from pyannote_audio_tpu_torch import Pipeline
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    from pyannote_audio_tpu_torch.pipelines.voice_activity_detection import \
        VoiceActivityDetection
    cfg = vad_config(config)
    pipeline = Pipeline.from_pretrained(cfg, device=device)
    cpu = Pipeline.from_pretrained(cfg, device="cpu")
    if not (isinstance(pipeline, VoiceActivityDetection)
            and next(pipeline._segmentation.model.parameters()).device.type
            == torch.device(device).type):
        raise AssertionError("(m) the VAD did not load onto the card")
    file = short_file()
    inference = pipeline._segmentation
    flips, chunk_window, num_chunks = powerset_flips(
        "(m) VAD's PyanNet, card vs CPU on 30 s", inference.model,
        cpu._segmentation.model, device, file["waveform"],
        inference.duration, inference.step)
    frames = inference.model.receptive_field
    offsets, _, _ = SpeakerDiarization._aggregation_grid(
        chunk_window, frames, num_chunks)
    with torch.inference_mode():
        ours = inference(dict(file)).data
        theirs = cpu._segmentation(dict(file)).data
    fed = np.zeros(len(theirs), dtype=bool)
    for c, f in flips:
        if offsets[c] + f < len(fed):
            fed[offsets[c] + f] = True
    differ = binarized_frames("(m) VAD speech scores (max over speakers), "
                              "card vs CPU on 30 s", ours, theirs, 0.5,
                              allowed=fed)
    a, b = pipeline(dict(file)), cpu(dict(file))
    log(f"(m) VAD on 30 s: {len(a)} vs {len(b)} speech segments, labels "
        f"{a.labels()}; equal: {a == b}")
    if not len(a) or a.labels() != ["SPEECH"] or (
            not differ.any() and a != b):
        raise AssertionError("(m) the VAD's speech timeline differs from "
                             "the CPU's")
    del cpu

    files = write_files(workdir, FILE_MINUTES)
    pipeline([dict(f) for f in files])                         # warm
    torch.cuda.synchronize()
    reset_lstm()
    outputs = pipeline([dict(f) for f in files])
    torch.cuda.synchronize()
    launches = lstm_launches()
    expected = 2 * len(segmentation_batches())
    wall = wall_seconds(lambda: pipeline([dict(f) for f in files]))
    log(f"(m) VAD on 10 + 3 min through the list path: "
        f"{[len(o) for o in outputs]} speech segments; lstm_recurrence "
        f"launches {launches} (expected {expected}: 2 layers x "
        f"{expected // 2} batches); warm pass {wall:.3f} s = "
        f"{wall * 60 / sum(FILE_MINUTES):.3f} s per audio-hour")
    if launches != expected or not all(len(o) for o in outputs):
        raise AssertionError("(m) the VAD did not run through the LSTM "
                             "kernel as expected")
    return launches


def non_powerset_pipeline(segmentation, embedding, device):
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    pipeline = SpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=BATCH_SIZE, embedding_batch_size=BATCH_SIZE,
        device=device)
    return pipeline.instantiate(NON_POWERSET_PARAMS)


@contextlib.contextmanager
def exact_path():
    """The exact path's settings: the accelerator gates "0" and the LSTM
    at "highest"; the gates are unset on exit."""
    with lstm_precision_env("highest"):
        set_gates("0")
        try:
            yield
        finally:
            set_gates(None)


def check_non_powerset_exact(model, device) -> None:
    """(n) non-powerset SpeakerDiarization, the card against the CPU on
    30 s on the exact path (float32 everywhere, as phase 4 holds the
    powerset one): the binarized chunk frames and the hard clusters."""
    from pyannote_audio_tpu_torch.ops.binarize import hysteresis
    file = short_file()
    seen = {}
    with exact_path():
        embedding = make_models(torch.float32)[1]
        for name, dev in (("card", device), ("cpu", "cpu")):
            pipeline = non_powerset_pipeline(
                copy.deepcopy(model).to(dev), copy.deepcopy(embedding), dev)
            seen[name] = traced_run(pipeline, file)
    (out, ours), (ref, theirs) = seen["card"], seen["cpu"]

    def binarize(scores):
        return hysteresis(torch.from_numpy(scores).transpose(0, 1),
                          ML_THRESHOLD, ML_THRESHOLD,
                          initial_on=False).transpose(0, 1).numpy()
    a, b = binarize(ours["scores"]), binarize(theirs["scores"])
    near = np.abs(theirs["scores"] - ML_THRESHOLD) <= NEAR_THRESHOLD
    differ = a != b
    touched = differ.any(axis=(1, 2))
    same = np.array_equal(ours["clusters"][~touched],
                          theirs["clusters"][~touched])
    log(f"(n) non-powerset diarization, exact path, card vs CPU on 30 s: "
        f"scores max_abs_err "
        f"{np.abs(ours['scores'] - theirs['scores']).max():.3e}; "
        f"{int(differ.sum())} of {differ.size} binarized chunk frames "
        f"differ, {int((differ & ~near).sum())} farther than "
        f"{NEAR_THRESHOLD} from the threshold (limit 0); hard clusters "
        f"equal on the {int((~touched).sum())} untouched chunks: {same}; "
        f"{len(out.speaker_diarization)} vs {len(ref.speaker_diarization)} "
        f"segments, labels {out.speaker_diarization.labels()}")
    if (differ & ~near).any() or not same or \
            not len(out.speaker_diarization):
        raise AssertionError("(n) non-powerset diarization on the card "
                             "disagrees with the CPU")


def check_multilabel(device, workdir: Path) -> dict:
    """(n) MultiLabelSegmentation and non-powerset SpeakerDiarization with
    make_multilabel_model: card against CPU on 30 s on the exact path,
    the accelerator path's distance from it as a measurement (bf16
    SincNet's rounding exceeds this random model's input-driven spread),
    then both timed on the card at its defaults with their LSTM
    launches."""
    from pyannote_audio_tpu_torch.pipelines.multilabel import \
        MultiLabelSegmentation
    model = make_multilabel_model()
    check_non_powerset_exact(model, device)
    cpu_model = copy.deepcopy(model)
    multilabel = MultiLabelSegmentation(
        model, batch_size=BATCH_SIZE, device=device).instantiate(ML_PARAMS)
    cpu = MultiLabelSegmentation(
        cpu_model, batch_size=BATCH_SIZE, device="cpu").instantiate(ML_PARAMS)
    file = short_file()
    with exact_path(), torch.inference_mode():
        ours = multilabel._segmentation(dict(file)).data
        theirs = cpu._segmentation(dict(file)).data
        a, b = multilabel(dict(file)), cpu(dict(file))
    differ = binarized_frames("(n) MultiLabelSegmentation scores, exact "
                              "path, card vs CPU on 30 s", ours, theirs,
                              ML_THRESHOLD)
    log(f"(n) MultiLabelSegmentation on 30 s: {len(a)} vs {len(b)} "
        f"segments, labels {a.labels()}; equal: {a == b}")
    if not len(a) or (not differ.any() and a != b):
        raise AssertionError("(n) MultiLabelSegmentation differs from the "
                             "CPU")
    del cpu, cpu_model
    with torch.inference_mode():
        fast = multilabel._segmentation(dict(file)).data
    flipped = (fast > ML_THRESHOLD) != (ours > ML_THRESHOLD)
    log(f"(n) measurement: the accelerator path's scores (bf16 SincNet, "
        f"\"default\" LSTM) against the exact path's on the card: "
        f"max_abs_err {np.abs(fast - ours).max():.3e}, {int(flipped.sum())} "
        f"of {flipped.size} binarized values differ")

    launches = {}
    ten = write_files(workdir, FILE_MINUTES[:1])[0]
    multilabel(dict(ten))                                       # warm
    torch.cuda.synchronize()
    reset_lstm()
    out = multilabel(dict(ten))
    torch.cuda.synchronize()
    launches["multilabel"] = lstm_launches()
    expected = ML_LSTM_LAYERS * len(segmentation_batches(
        FILE_MINUTES[:1], ML_CHUNK_SECONDS))
    wall = wall_seconds(lambda: multilabel(dict(ten)))
    log(f"(n) MultiLabelSegmentation on {FILE_MINUTES[0]:g} min: {len(out)} "
        f"segments over {out.labels()}; lstm_recurrence launches "
        f"{launches['multilabel']} (expected {expected}: {ML_LSTM_LAYERS} "
        f"layers x {expected // ML_LSTM_LAYERS} batches of 5 s chunks); "
        f"warm pass {wall:.3f} s = {wall * 60 / FILE_MINUTES[0]:.3f} s per "
        f"audio-hour")
    if launches["multilabel"] != expected or not len(out):
        raise AssertionError("(n) MultiLabelSegmentation did not run "
                             "through the LSTM kernel as expected")

    pipeline = non_powerset_pipeline(model, make_models(torch.bfloat16)[1],
                                     device)
    files = write_files(workdir, FILE_MINUTES)
    run_batch(pipeline, files)                                  # warm
    torch.cuda.synchronize()
    reset_counts(pipeline)
    outputs = run_batch(pipeline, files)
    torch.cuda.synchronize()
    counts = read_counts(pipeline)
    check_outputs(files, outputs)
    expected = ML_LSTM_LAYERS * len(segmentation_batches(FILE_MINUTES,
                                                         ML_CHUNK_SECONDS))
    log(f"(n) non-powerset diarization, 10 + 3 min through apply_batch: "
        f"counts {counts} (lstm_launches expected {expected})")
    if counts["lstm_launches"] != expected:
        raise AssertionError("(n) non-powerset diarization did not run "
                             "through the LSTM kernel as expected")
    launches["diarization (non-powerset)"] = counts["lstm_launches"]
    timed_passes(pipeline, files, sum(FILE_MINUTES),
                 "(n) non-powerset diarization")
    return launches


def write_wav_as(path: Path, waveform: np.ndarray, rate: int,
                 encoding: str) -> None:
    """A (channel, time) waveform as 24-bit PCM ("pcm24") or float32
    ("float32") WAV."""
    import struct
    frames = waveform.T
    if encoding == "float32":
        code, bits, data = 3, 32, frames.astype("<f4").tobytes()
    else:
        ints = np.clip(np.round(frames * 2.0 ** 23), -2 ** 23,
                       2 ** 23 - 1).astype("<i4").ravel()
        code, bits = 1, 24
        data = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    channels = waveform.shape[0]
    block = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, code, channels, rate,
                            rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


def check_audio(pipeline, workdir: Path) -> None:
    """(o) High-rate WAVs through SpeakerDiarization on the card against
    the same audio pre-resampled to 16 kHz PCM16 by the port's own
    resampler; then ``_predecode_batch`` against one-by-one decode."""
    from pyannote_audio_tpu_torch.core.io import Audio, write_wav
    sources = {
        "44.1 kHz stereo 24-bit": (np.stack([
            synth(AUDIO_MINUTES, seed=11, rate=44100),
            synth(AUDIO_MINUTES, seed=12, rate=44100)]), 44100, "pcm24"),
        "48 kHz float32": (synth(AUDIO_MINUTES, seed=13, rate=48000)[None],
                           48000, "float32")}
    audio = Audio(sample_rate=SAMPLE_RATE)
    frames = pipeline._segmentation.model.receptive_field
    high_rate = []
    for k, (label, (waveform, rate, encoding)) in enumerate(sources.items()):
        path = workdir / f"audio_{k}_{rate}.wav"
        write_wav_as(path, waveform, rate, encoding)
        del waveform
        high_rate.append({"audio": str(path), "uri": path.stem})
        resampled, _ = audio(str(path))
        pcm16_path = workdir / f"audio_{k}_16k.wav"
        write_wav(pcm16_path, resampled, SAMPLE_RATE)
        pcm16, _ = audio(str(pcm16_path))
        file = {"audio": str(path), "uri": path.stem}
        reference = {"audio": str(pcm16_path), "uri": pcm16_path.stem}
        pipeline(dict(file), max_speakers=4)                    # warm
        decode = {}
        for name, f in (("high", file), ("pcm16", reference)):
            seconds = {}
            with stage_timer(pipeline, seconds):
                wall = wall_seconds(lambda: pipeline(dict(f), max_speakers=4))
            decode[name] = (seconds["decode"], wall)
        log(f"(o) {label} WAV, {AUDIO_MINUTES:g} min, through "
            f"SpeakerDiarization on the card: decode + downmix + resample "
            f"stage {decode['high'][0]:.3f} s in a {decode['high'][1]:.3f} s "
            f"pass; the same audio as 16 kHz PCM16: decode "
            f"{decode['pcm16'][0]:.3f} s in {decode['pcm16'][1]:.3f} s")
        check_same_diarization(
            f"(o) {label} vs pre-resampled 16 kHz PCM16",
            traced_run(pipeline, file), traced_run(pipeline, reference),
            logprobs(pipeline, resampled), logprobs(pipeline, pcm16), frames)

    files = write_files(workdir, SERVING_MINUTES) + high_rate
    batch = [dict(f) for f in files]
    start = time.perf_counter()
    pipeline._predecode_batch(batch)
    batch_s = time.perf_counter() - start
    one_by_one = [dict(f) for f in files]
    start = time.perf_counter()
    for f in one_by_one:
        pipeline._decode_into(f, False)
    sequential_s = time.perf_counter() - start
    err = max(np.abs(np.asarray(a["waveform"]) - np.asarray(b["waveform"]))
              .max() for a, b in zip(batch, one_by_one))
    shapes = all(np.asarray(a["waveform"]).shape
                 == np.asarray(b["waveform"]).shape
                 for a, b in zip(batch, one_by_one))
    log(f"(o) _predecode_batch on the serving list and the two high-rate "
        f"files ({sum(SERVING_MINUTES) + 2 * AUDIO_MINUTES:g} min): "
        f"{batch_s:.3f} s of host time, one by one {sequential_s:.3f} s; "
        f"waveforms max_abs_err {err:.3e} (limit {PREDECODE_ATOL})")
    if not (shapes and err <= PREDECODE_ATOL
            and all(f.get("_batch_decoded") for f in batch)):
        raise AssertionError("(o) the batch decoder disagrees with "
                             "one-by-one decode")


def partition_equal(a: np.ndarray, b: np.ndarray) -> bool:
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == \
        len({y for _, y in pairs})


def check_device_ahc(pipeline, device, workdir: Path) -> dict:
    """(p) PYANNOTE_TPU_DEVICE_AHC=1 against host scipy on the serving
    list: partitions, linkages and times."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from pyannote_audio_tpu_torch.ops.ahc import device_linkage
    from pyannote_audio_tpu_torch.pipelines.clustering import _unit
    from pyannote_audio_tpu_torch.telemetry import spans
    files = write_files(workdir, SERVING_MINUTES)
    passes, inputs, results = {}, {}, {}
    for gate in ("0", "1", "0", "1"):
        with environ({"PYANNOTE_TPU_DEVICE_AHC": gate}):
            run_batch(pipeline, files[-2:])                     # warm
            captured = []

            def call(gate=gate):
                results[gate] = run_batch(pipeline, files)
            with spans.recording() as recording, \
                    clustering_inputs(pipeline, captured):
                wall = wall_seconds(call)
        seconds = dict(recorded_seconds(recording), wall=wall)
        passes.setdefault(gate, []).append(seconds)
        inputs[gate] = captured
    for gate, label in (("0", "host scipy"), ("1", "device AHC")):
        log(f"(p) serving list {sum(SERVING_MINUTES):g} min through "
            f"apply_batch, {label}: " + "; ".join(
                f"wall {r['wall']:.3f} s, _finalize {r['finalize']:.3f} s "
                f"(clustering {r['clustering']:.3f} s)"
                for r in passes[gate]))
    clustering = pipeline.clustering
    totals = {"scipy": 0.0, "device": 0.0}
    for f, (args, kwargs, host_out), dev_res, host_res in zip(
            files, inputs["0"], results["1"], results["0"]):
        embeddings, clean_frames = args
        train, _, _ = clustering.filter_embeddings(
            embeddings, clean_frames, kwargs["num_frames"])
        normed = _unit(train)
        start = time.perf_counter()
        host_z = linkage(normed, method="centroid", metric="euclidean")
        scipy_s = time.perf_counter() - start
        device_linkage(normed[:8], device=device)               # warm
        start = time.perf_counter()
        dev_z = device_linkage(normed, device=device)
        device_s = time.perf_counter() - start
        totals["scipy"] += scipy_s
        totals["device"] += device_s
        threshold = clustering.threshold
        heights, dev_heights = np.sort(host_z[:, 2]), np.sort(dev_z[:, 2])
        heights_ok = np.allclose(dev_heights, heights, rtol=AHC_HEIGHT_RTOL,
                                 atol=AHC_HEIGHT_ATOL)
        cut_same = partition_equal(
            fcluster(host_z, threshold, criterion="distance"),
            fcluster(dev_z, threshold, criterion="distance"))
        # the first merge where the two sequences part: there both picked
        # a pair at the least distance, so the heights must agree there
        # within AHC_TIE (a near tie that float32 and float64 order apart)
        parted = np.flatnonzero((np.sort(host_z[:, :2], axis=1)
                                 != np.sort(dev_z[:, :2], axis=1)).any(1))
        first = int(parted[0]) if len(parted) else None
        gap = abs(host_z[first, 2] - dev_z[first, 2]) if first is not None \
            else 0.0
        with environ({"PYANNOTE_TPU_DEVICE_AHC": "1"}):
            dev_out = clustering(*args, **kwargs)
        same = partition_equal(dev_out[0], host_out[0])
        same_annotation = dev_res.speaker_diarization == \
            host_res.speaker_diarization
        log(f"(p) {f['uri']}: {len(train)} embeddings clustered; linkage "
            f"scipy {scipy_s * 1e3:.1f} ms, device {device_s * 1e3:.1f} ms; "
            f"sorted heights within rtol {AHC_HEIGHT_RTOL} / atol "
            f"{AHC_HEIGHT_ATOL}: {heights_ok} (max diff "
            f"{np.abs(dev_heights - heights).max(initial=0.0):.3e}); merge "
            f"sequences part at step {first} of {len(host_z)}, height gap "
            f"there {gap:.3e} (limit {AHC_TIE}); cut at {threshold} equal: "
            f"{cut_same}; pipeline hard clusters equal: {same}, annotation "
            f"equal: {same_annotation}; last merge covers "
            f"{int(dev_z[-1, 3]) if len(dev_z) else 1} of {len(train)}")
        if not (heights_ok and gap <= AHC_TIE and (
                len(dev_z) == 0 or int(dev_z[-1, 3]) == len(train))):
            raise AssertionError(f"(p) device linkage disagrees with scipy "
                                 f"on {f['uri']}")
        if first is None and not (cut_same and same and same_annotation):
            raise AssertionError(f"(p) the same merges gave another "
                                 f"partition on {f['uri']}")
    log(f"(p) linkage of the serving list's embeddings: scipy "
        f"{totals['scipy']:.3f} s, device {totals['device']:.3f} s")
    return {"passes": passes, "linkage": totals}


def check_binarize_aggregate(model, device) -> None:
    """(q) ``ops.binarize.hysteresis`` and ``ops.aggregate.
    aggregate_scores`` on the card against the CPU at the VAD's sizes on
    the serving list (10 s chunks at 1 s steps, one score per frame, a
    NaN stretch in every chunk)."""
    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    from pyannote_audio_tpu_torch.ops.aggregate import aggregate_scores
    from pyannote_audio_tpu_torch.ops.binarize import hysteresis
    frames = model.receptive_field
    per_chunk = model.num_frames(10 * SAMPLE_RATE)
    rng = np.random.default_rng(13)
    worst, card_ms, hysteresis_ms, cpu_ms, sizes = 0.0, 0.0, 0.0, 0.0, []
    for minutes in SERVING_MINUTES:
        n = int(minutes * 60 * SAMPLE_RATE)
        starts, _ = _chunk_grid(n, 10 * SAMPLE_RATE, SAMPLE_RATE)
        scores = rng.random((len(starts), per_chunk, 1), dtype=np.float32)
        scores[:, 100:140] = np.nan
        offsets = np.rint((starts / SAMPLE_RATE - frames.start)
                          / frames.step).astype(np.int64)
        total = max(int(n / SAMPLE_RATE / frames.step),
                    int(offsets[-1]) + per_chunk)
        host = (torch.from_numpy(scores), torch.from_numpy(offsets))
        card = tuple(t.to(device) for t in host)
        start = time.perf_counter()
        ref = aggregate_scores(*host, total, hamming=True, missing=0.0)
        binary_ref = hysteresis(ref, 0.6, 0.4)
        cpu_ms += (time.perf_counter() - start) * 1e3
        out = aggregate_scores(*card, total, hamming=True, missing=0.0)
        worst = max(worst, (out.cpu() - ref).abs().max().item())
        if not (torch.isfinite(out).all() and torch.equal(
                hysteresis(ref.to(device), 0.6, 0.4).cpu(), binary_ref)):
            raise AssertionError("(q) hysteresis on the card differs from "
                                 "the CPU")
        card_ms += cuda_ms(lambda: aggregate_scores(
            *card, total, hamming=True, missing=0.0), runs=10)
        hysteresis_ms += cuda_ms(lambda: hysteresis(out, 0.6, 0.4), runs=10)
        sizes.append((len(starts), total))
    log(f"(q) aggregate_scores + hysteresis at the serving list's VAD sizes "
        f"(chunks, output frames) {sizes}: aggregation card vs CPU "
        f"max_abs_err {worst:.3e} (limit {AGGREGATE_ATOL}); hysteresis "
        f"equal; card {card_ms:.3f} ms + {hysteresis_ms:.3f} ms (medians of "
        f"10, summed over the files), CPU {cpu_ms:.1f} ms for both")
    if worst > AGGREGATE_ATOL:
        raise AssertionError("(q) aggregation on the card differs from the "
                             "CPU")


def phase_vad_multilabel_audio(device, workdir: Path, pipeline,
                               config: dict) -> dict:
    """Phase 8: VAD, multilabel and non-powerset diarization, audio at any
    rate, device AHC, device hysteresis and aggregation; returns the LSTM
    launches of each new path."""
    set_gates(None)
    launches = {"vad": check_vad(device, workdir, config)}
    launches.update(check_multilabel(device, workdir))
    check_audio(pipeline, workdir)
    check_device_ahc(pipeline, device, workdir)
    check_binarize_aggregate(pipeline._segmentation.model, device)
    return launches


# -- phase 9 ------------------------------------------------------------------

# (r): one batch of 32 five-second chunks per embedder, card against the
# CPU on the whole batch (EMBED_CPU_ROWS of it where set), unmasked
# and masked; float32 models at cosine > 0.9999 and relative L2 <= 1e-3 per finite
# row; the bf16 WeSpeaker trunks by the bound of
# tests/test_torch_port_models.py (card against CPU within 2e-2 of the
# largest float32 value, 2e-3 in the mean, and no farther from the CPU's
# float32 embeddings than twice the CPU's bf16 ones); NaN at the same rows
EMBED_BATCH = 32
EMBED_SECONDS = 5.0
EMBED_MIN_COS = 0.9999
EMBED_REL_L2 = 1e-3
EMBED_BF16_MAX, EMBED_BF16_MEAN = 2e-2, 2e-3
EMBED_RUNS = 20
# rows of the batch held card against CPU, where the CPU's passes are long
# (ResNet293's four: bf16 and its float32 reference, unmasked and masked;
# ResNet34's, ECAPA's and TitaNet's eight, 0.3-0.6 s a row); the first 4
# rows hold every mask pattern once
EMBED_CPU_ROWS = {"WeSpeakerResNet293 (.onnx)": 4,
                  "WeSpeakerResNet34 (.onnx)": 8,
                  "ECAPA_TDNN (SpeechBrain snapshot)": 8,
                  "TitaNet-large (NeMo state dict)": 8}
# (s): three 1-minute files; the Inference's default batch of 32 chunks
SPEAKER_EMBEDDING_MINUTES = (1.0, 1.0, 1.0)
INFERENCE_BATCH = 32
ECAPA_HYPERPARAMS = ("sample_rate: 16000\nn_mels: 80\n"
                     "embedding_model: !new:speechbrain.lobes.models."
                     "ECAPA_TDNN.ECAPA_TDNN\n"
                     "    channels: [1024, 1024, 1024, 1024, 3072]\n"
                     "    kernel_sizes: [5, 3, 3, 3, 1]\n"
                     "    dilations: [1, 2, 3, 4, 1]\n"
                     "    attention_channels: 128\n    lin_neurons: 192\n")


def embed_batch():
    """(32, 1, 80000) chunks of a synthetic minute, and (32, 293) masks
    cycling over: all speech, random speech, 2 frames (too short for every
    embedder: 546 samples), the first half."""
    audio = synth(1.0, seed=20)
    n = int(EMBED_SECONDS * SAMPLE_RATE)
    starts = (np.arange(EMBED_BATCH) * 1.7 * SAMPLE_RATE).astype(int) \
        % (len(audio) - n)
    wav = np.stack([audio[s:s + n] for s in starts])[:, None]
    rng = np.random.default_rng(21)
    masks = np.zeros((EMBED_BATCH, 293), np.float32)
    masks[0::4] = 1.0
    masks[1::4] = rng.uniform(size=(EMBED_BATCH // 4, 293)) > 0.3
    masks[2::4, :2] = 1.0
    masks[3::4, :146] = 1.0
    return wav, masks


def _onnx_of(model, path: Path) -> str:
    """A WeSpeaker-style .onnx file of ``model``'s weights (the bare
    ResNet's names, no BatchNorm counters)."""
    from pyannote_audio_tpu_torch.utils.onnx import write_onnx_initializers
    write_onnx_initializers(path, {
        k[len("resnet."):]: v.numpy() for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")})
    return str(path)


def write_embedders(root: Path) -> list:
    """Each embedder at its published width with seeded weights, written
    where its real route reads it; returns (label, build(device) -> the
    route's wrapper, "float32" | "bf16")."""
    from pyannote_audio_tpu_torch.models.embedding import (
        ECAPA_TDNN, TitaNet, WeSpeakerResNet34, WeSpeakerResNet293,
        XVectorMFCC, XVectorSincNet)
    from pyannote_audio_tpu_torch.models.embedding.titanet import \
        export_nemo_state_dict
    from pyannote_audio_tpu_torch.pipelines.speaker_verification import (
        NeMoPretrainedSpeakerEmbedding, PretrainedSpeakerEmbedding)
    from pyannote_audio_tpu_torch.utils.convert import \
        write_reference_checkpoint
    root.mkdir(parents=True, exist_ok=True)

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    routes = []
    for depth, klass, seed in ((34, WeSpeakerResNet34, 40),
                               (293, WeSpeakerResNet293, 41)):
        path = _onnx_of(klass(generator=seeded(seed)),
                        root / f"wespeaker-resnet{depth}.onnx")
        routes.append((f"WeSpeakerResNet{depth} (.onnx)",
                       lambda device, path=path:
                       PretrainedSpeakerEmbedding(path, device=device),
                       "bf16"))
    ecapa_dir = root / "spkrec-ecapa"
    ecapa_dir.mkdir(exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in ECAPA_TDNN(
        generator=seeded(42)).export_speechbrain_state_dict().items()},
        ecapa_dir / "embedding_model.ckpt")
    (ecapa_dir / "hyperparams.yaml").write_text(ECAPA_HYPERPARAMS)
    routes.append(("ECAPA_TDNN (SpeechBrain snapshot)",
                   lambda device: PretrainedSpeakerEmbedding(
                       str(ecapa_dir), device=device), "float32"))
    nemo_state = export_nemo_state_dict(TitaNet(generator=seeded(43)))
    routes.append(("TitaNet-large (NeMo state dict)",
                   lambda device: NeMoPretrainedSpeakerEmbedding(
                       TitaNet().convert_nemo_state_dict(nemo_state),
                       device=device), "float32"))
    for klass, seed in ((XVectorSincNet, 44), (XVectorMFCC, 45)):
        model = klass(generator=seeded(seed))
        path = write_reference_checkpoint(
            model.state_dict(), klass.__name__, model.reference_hparams(),
            None, root / klass.__name__)
        routes.append((f"{klass.__name__} (pytorch_model.bin)",
                       lambda device, path=path:
                       PretrainedSpeakerEmbedding(str(path), device=device),
                       "float32"))
    return routes, ecapa_dir


def embedding_agreement(label: str, ours: np.ndarray, theirs: np.ndarray,
                        ref_f32: np.ndarray = None) -> str:
    """Hold card embeddings ``ours`` to the CPU's ``theirs`` (NaN rows
    equal; float32 by cosine and relative L2, bf16 by the trunk bound
    against the CPU's float32 ``ref_f32``); returns the printed values."""
    nan_ours, nan_theirs = np.isnan(ours).all(-1), np.isnan(theirs).all(-1)
    if not (np.array_equal(nan_ours, nan_theirs)
            and np.isfinite(ours[~nan_ours]).all()):
        raise AssertionError(f"(r) {label}: NaN rows differ between the "
                             f"card ({np.flatnonzero(nan_ours)}) and the "
                             f"CPU ({np.flatnonzero(nan_theirs)})")
    a, b = ours[~nan_ours], theirs[~nan_theirs]
    if ref_f32 is None:
        cos = cosines(a, b).min()
        rel = (np.linalg.norm(a - b, axis=-1)
               / np.linalg.norm(b, axis=-1)).max()
        ok = cos > EMBED_MIN_COS and rel <= EMBED_REL_L2
        text = (f"cosine min {cos:.7f} (limit > {EMBED_MIN_COS}), "
                f"relative L2 max {rel:.3e} (limit {EMBED_REL_L2})")
    else:
        f32 = ref_f32[~nan_theirs]
        scale = np.abs(f32).max()
        err = np.abs(a - b)
        ours_f32, cpu_f32 = np.abs(a - f32), np.abs(b - f32)
        ok = (err.max() <= EMBED_BF16_MAX * scale
              and err.mean() <= EMBED_BF16_MEAN * scale
              and ours_f32.max() <= 2 * cpu_f32.max()
              and ours_f32.mean() <= 2 * cpu_f32.mean())
        text = (f"card vs CPU bf16 max {err.max() / scale:.3e} / mean "
                f"{err.mean() / scale:.3e} of the float32 scale (limits "
                f"{EMBED_BF16_MAX} / {EMBED_BF16_MEAN}); from float32: card "
                f"max {ours_f32.max():.3e} mean {ours_f32.mean():.3e}, CPU "
                f"bf16 max {cpu_f32.max():.3e} mean {cpu_f32.mean():.3e} "
                f"(limit 2x)")
    if not ok or not len(a):
        raise AssertionError(f"(r) {label}: the card disagrees with the "
                             f"CPU: {text}")
    return text


def check_embedders(device, workdir: Path, card: str) -> Path:
    """(r) Each embedder through its route, card against CPU, unmasked and
    masked, and its time per batch with the operations it counts;
    returns the ECAPA snapshot."""
    from torch.utils.flop_counter import FlopCounterMode
    routes, ecapa_dir = write_embedders(workdir / "embedders")
    wav, masks = embed_batch()
    # the x-vectors' SincNet on the exact path (its bf16 gate off), as
    # every float32 module of the slice
    with environ({"PYANNOTE_TPU_SEG_BF16": "0"}):
        for label, build, precision in routes:
            ours, cpu = build(device), build("cpu")
            texts = []
            rows = EMBED_CPU_ROWS.get(label, EMBED_BATCH)
            start = time.perf_counter()
            for name, m in (("unmasked", None), ("masked", masks[:rows])):
                a, b = ours(wav[:rows], m), cpu(wav[:rows], m)
                ref = None
                if precision == "bf16":
                    cpu.model.compute_dtype = torch.float32
                    ref = cpu(wav[:rows], m)
                    cpu.model.compute_dtype = torch.bfloat16
                texts.append(f"{name}: {embedding_agreement(label, a, b, ref)}"
                             f"; NaN rows {np.flatnonzero(np.isnan(a).all(-1))}"
                             )
            check_s = time.perf_counter() - start
            x = torch.from_numpy(wav).to(device)
            with torch.inference_mode():
                ms = cuda_ms(lambda: ours.model(x), runs=EMBED_RUNS)
                with FlopCounterMode(display=False) as counter:
                    ours.model(x)
            flops = counter.get_total_flops()
            log(f"(r) {label}, {EMBED_BATCH} x {EMBED_SECONDS:g} s chunks, "
                f"{precision}, {ours.dimension}-d: {ms:.3f} ms per batch "
                f"(median of {EMBED_RUNS}, CUDA events; {card}); "
                f"{flops / 1e12:.4f} TFLOP of convolutions and matmuls "
                f"(torch's FlopCounterMode) = {flops / ms / 1e9:.1f} "
                f"TFLOP/s; card vs CPU on {rows} of the {EMBED_BATCH} rows "
                f"({check_s:.1f} s with the CPU's passes)")
            for text in texts:
                log(f"    {text}")
            del ours, cpu
    return ecapa_dir


def check_speaker_embedding(device, workdir: Path, config: dict,
                            ecapa_dir: Path, card: str) -> int:
    """(s) SpeakerEmbedding from a config dict, VAD-weighted by (l)'s
    PyanNet, over the ECAPA snapshot: card against CPU on the exact path
    with its LSTM launches, a timed warm pass at the defaults, then the
    EER over seeded trials; returns the LSTM launches."""
    import math

    from pyannote_audio_tpu_torch import Pipeline
    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    from pyannote_audio_tpu_torch.pipelines.speaker_verification import (
        SpeakerEmbedding, verification_trials_eer)
    cfg = {"checkpoint": config["checkpoint"], "pipeline": {
        "name": "pyannote.audio.pipelines.SpeakerEmbedding",
        "params": {"embedding": str(ecapa_dir),
                   "segmentation": "$model/segmentation"}}}
    files = write_files(workdir, SPEAKER_EMBEDDING_MINUTES)
    window = 10 * SAMPLE_RATE
    expected = 2 * sum(math.ceil(len(_chunk_grid(
        int(m * 60 * SAMPLE_RATE), window, window // 10)[0])
        / INFERENCE_BATCH) for m in SPEAKER_EMBEDDING_MINUTES)
    with exact_path():
        pipeline = Pipeline.from_pretrained(cfg, device=device)
        cpu = Pipeline.from_pretrained(cfg, device="cpu")
        if not isinstance(pipeline, SpeakerEmbedding) or \
                pipeline._embedding.device.type != torch.device(device).type:
            raise AssertionError("(s) SpeakerEmbedding did not load onto "
                                 "the card")
        reset_lstm()
        ours = np.concatenate([pipeline(dict(f)) for f in files])
        torch.cuda.synchronize()
        launches = lstm_launches()
        theirs = np.concatenate([cpu(dict(f)) for f in files])
    text = embedding_agreement("(s) SpeakerEmbedding", ours, theirs)
    log(f"(s) SpeakerEmbedding (ECAPA, VAD-weighted by PyanNet) on 3 x 1 "
        f"min, exact path, card vs CPU: {text}; lstm_recurrence launches "
        f"{launches} (expected {expected}: 2 layers x {expected // 2} "
        f"batches of {INFERENCE_BATCH} chunks)")
    if launches != expected or ours.shape != (3, 192):
        raise AssertionError("(s) SpeakerEmbedding did not run through the "
                             "LSTM kernel as expected")
    del cpu
    pipeline = Pipeline.from_pretrained(cfg, device=device)
    [pipeline(dict(f)) for f in files]                      # warm
    wall = wall_seconds(lambda: [pipeline(dict(f)) for f in files])
    rng = np.random.default_rng(22)
    trials = [{"file1": dict(files[i]), "file2": dict(files[j]),
               "reference": int(rng.integers(2))}
              for i in range(3) for j in range(i, 3)]
    eer = verification_trials_eer(pipeline, trials)
    log(f"(s) at the defaults: warm pass {wall:.3f} s for 3 min of audio "
        f"({card}); verification_trials_eer over {len(trials)} seeded "
        f"trials = {eer:.4f} (random weights: not a quality claim)")
    if not np.isfinite(eer):
        raise AssertionError("(s) the EER is not finite")
    return launches


def xvector_pipeline(config: dict, embedding: str, device):
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    pipeline = SpeakerDiarization(
        segmentation=str(Path(config["checkpoint"]) / "segmentation"),
        embedding=embedding, clustering="AgglomerativeClustering",
        segmentation_batch_size=BATCH_SIZE, embedding_batch_size=BATCH_SIZE,
        device=device)
    return pipeline.instantiate(PARAMS)


def check_xvector_diarization(device, workdir: Path, config: dict,
                              card: str) -> int:
    """(t) SpeakerDiarization with an XVectorSincNet embedding (a reference
    checkpoint) on 10 + 3 min through apply_batch at the defaults, then
    the card against the CPU on the 3-minute file on the exact path by
    (g)'s near-tie rule; returns the LSTM launches."""
    import math

    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    embedding = str(workdir / "embedders" / "XVectorSincNet")
    files = write_files(workdir, FILE_MINUTES)
    set_gates(None)
    pipeline = xvector_pipeline(config, embedding, device)
    run_batch(pipeline, files)                                  # warm
    torch.cuda.synchronize()
    reset_counts(pipeline)
    outputs = run_batch(pipeline, files)
    torch.cuda.synchronize()
    counts = read_counts(pipeline)
    wall = wall_seconds(lambda: run_batch(pipeline, files))
    check_outputs(files, outputs)
    window = 10 * SAMPLE_RATE
    batches = len(segmentation_batches())
    chunk_batches = sum(math.ceil(len(_chunk_grid(
        int(m * 60 * SAMPLE_RATE), window, window // 10)[0]) / BATCH_SIZE)
        for m in FILE_MINUTES)
    expected = {"whole_conv": len(files), "whole_fbank": 0,
                "trunk_panel_batches": 0,
                "chunk_trunk_batches": chunk_batches,
                "lstm_launches": 2 * batches}
    log(f"(t) x-vector diarization, 10 + 3 min through apply_batch: counts "
        f"{counts} (expected {expected}: the per-chunk embedding path); "
        f"warm pass {wall:.3f} s = {wall * 60 / sum(FILE_MINUTES):.3f} s "
        f"per audio-hour ({card})")
    if counts != expected:
        raise AssertionError("(t) the x-vector pipeline did not take the "
                             "per-chunk path through the LSTM kernel")
    with exact_path():
        ours = xvector_pipeline(config, embedding, device)
        theirs = xvector_pipeline(config, embedding, "cpu")
        waveform = synth(FILE_MINUTES[1], seed=1)[None]
        check_same_diarization(
            "(t) x-vector diarization on 3 min, card vs CPU, exact path",
            traced_run(ours, files[1]), traced_run(theirs, files[1]),
            logprobs(ours, waveform).cpu(), logprobs(theirs, waveform),
            ours._segmentation.model.receptive_field)
    return counts["lstm_launches"]


def check_resnet293_diarization(device, workdir: Path, card: str) -> int:
    """(u) SpeakerDiarization with a full-width ResNet293 (bf16 trunk) on
    the 3-minute file: the shared-trunk path, its panels against one
    unpanelled pass, peak memory; returns the LSTM launches."""
    from pyannote_audio_tpu_torch.models.embedding import WeSpeakerResNet293
    set_gates(None)
    segmentation, _ = make_models(torch.bfloat16)
    pipeline = build_pipeline(
        segmentation, WeSpeakerResNet293(
            generator=torch.Generator().manual_seed(41)), device)
    file = write_files(workdir, FILE_MINUTES)[1]
    pipeline(dict(file), max_speakers=4)                        # warm
    torch.cuda.synchronize()
    reset_counts(pipeline)
    peak, wall = peak_and_wall(
        device, lambda: check_outputs([file], [pipeline(
            dict(file), max_speakers=4)]))
    counts = read_counts(pipeline)
    log(f"(u) ResNet293 (bf16) diarization on 3 min: counts {counts}; wall "
        f"{wall:.3f} s; peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated; {card})")
    if not (counts["trunk_panel_batches"] > 0
            and counts["chunk_trunk_batches"] == 0):
        raise AssertionError("(u) ResNet293 did not take the shared trunk")
    waveform = torch.from_numpy(synth(FILE_MINUTES[1], seed=1)[None]).to(
        device)
    with torch.inference_mode():
        check_panels(pipeline, waveform, "(u)")
    return counts["lstm_launches"]


def phase_embedders(device, workdir: Path, config: dict, card: str) -> dict:
    """Phase 9: every embedder through its route, SpeakerEmbedding with
    VAD weighting, diarization with an x-vector and with ResNet293;
    returns the LSTM launches of each new path."""
    log(f"phase 9, embedders, on {card}")
    ecapa_dir = check_embedders(device, workdir, card)
    launches = {"speaker embedding (s)": check_speaker_embedding(
        device, workdir, config, ecapa_dir, card)}
    launches["x-vector diarization (t)"] = check_xvector_diarization(
        device, workdir, config, card)
    launches["ResNet293 diarization (u)"] = check_resnet293_diarization(
        device, workdir, card)
    return launches


# -- phase 10 -----------------------------------------------------------------

# (v): SSeRiouSS at its defaults (WAVLM_BASE: 768 x 12 layers, 12 heads,
# FFN 3072, WavLM's relative position bias; a 4 x 128 BiLSTM, 2 x 128
# linears, 10 s chunks as a 7-class powerset; seeded, its head
# calibrated) in SpeakerDiarization with ResNet34, segmentation batches
# of 32 (the JAX package's default). The
# card's log-probs under "highest" against the CPU's on SSL_CPU_CHUNKS
# rows of one batch, within the exact path's bound; under "default"
# (the LSTM's bf16 products) within SSL_DEFAULT_LOGP_ATOL, about twice
# what the first card runs measured (2.547e-01; PERF.md), and every
# powerset flip a near tie (the rule of (m) and (n))
SSL_BATCH = 32
SSL_CPU_CHUNKS = 8
SSL_CHUNK_SECONDS = 10.0
SSL_DEFAULT_LOGP_ATOL = 0.5
# (w): ToTaToNet at its defaults (64 filters, k 32, s 16; DPRNN 6 repeats,
# bn 128, hid 128, chunk 100; 3 sources) with the WAVLM_LARGE branch, on 5
# s chunks at a step of 0.5 s, batches of 32; SEP_CPU_CHUNKS rows of one
# batch held to the CPU, and SpeechSeparation on a SEP_SHORT_SECONDS file
# held to the CPU's run of the same pipeline
SEP_BATCH = 32
SEP_CHUNK_SECONDS = 5.0
SEP_MINUTES = 3.0
SEP_CPU_CHUNKS = 4  # the CPU's pass takes about 2 s a chunk
SEP_SHORT_SECONDS = 15.0
SEP_DIAR_ATOL = 1e-4
SEP_SOURCES_REL_L2 = 1e-4
# under "default" (the LSTM's bf16 products): about 10x and 4x what the
# first card run measured (2.0e-06 and 2.7e-03; PERF.md)
SEP_DEFAULT_DIAR_ATOL = 2e-5
SEP_DEFAULT_SOURCES_REL_L2 = 1e-2
SEP_PARAMS = {"segmentation": {"min_duration_off": 0.0, "threshold": 0.5},
              "separation": {"leakage_removal": True, "asr_collar": 0.1},
              "clustering": {"method": "centroid", "threshold": 0.1,
                             "min_cluster_size": 1}}
# the random head's logits are calibrated to this spread around 0 on the
# synthetic audio (at init they barely move: every score a near tie)
SEP_LOGIT_SPREAD = 1.5


def mesh_shard_sizes(batches) -> list:
    """The batch sizes a MESH_DEVICES mesh splits ``batches`` into (as
    ``torch.tensor_split`` does: the first shards one longer)."""
    n = len(MESH_DEVICES)
    return [B // n + (k < B % n) for B in batches for k in range(n)
            if B // n + (k < B % n)]


def phase14_lstm_shapes() -> list:
    """(name, T, B, D_in) of the LSTM launches phase 14 adds: (G)'s mesh
    shards of the 10 + 3 min batches (256, 256, 79, 171 -> 128, 40 / 39,
    86 / 85) and each DDP rank's share of (H)'s batch of 32 (16)."""
    sizes = sorted(set(mesh_shard_sizes(segmentation_batches())),
                   reverse=True) + [DDP_BATCH // DDP_WORLD]
    return [(f"phase 14 B={B} layer 1", 589, B, 256) for B in sizes]


def phase10_lstm_shapes() -> list:
    """(name, T, B, D_in) of the LSTM launches of phase 10: DPRNN's at a
    full batch and at the 3-minute file's tail, SSeRiouSS's at every
    batch size of (v)."""
    frames = 1 + (int(SEP_CHUNK_SECONDS * SAMPLE_RATE) - 32) // 16
    K = 100
    folds = (frames + 2 * K - K) // (K // 2) + 1
    shapes = []
    for B in sorted(set(segmentation_batches(
            (SEP_MINUTES,), SEP_CHUNK_SECONDS, SEP_BATCH)), reverse=True):
        shapes += [(f"DPRNN intra B={B}x{folds}", K, B * folds, 128),
                   (f"DPRNN inter B={B}x{K}", folds, B * K, 128)]
    T = 1 + (int(SSL_CHUNK_SECONDS * SAMPLE_RATE) - 400) // 320
    for B in sorted(set(segmentation_batches(
            FILE_MINUTES, SSL_CHUNK_SECONDS, SSL_BATCH)), reverse=True):
        shapes += [(f"SSeRiouSS B={B} layer 0", T, B, 768),
                   (f"SSeRiouSS B={B} layers 1-3", T, B, 256)]
    return shapes


def chunk_batch(minutes: float, seconds: float, batch: int, seed: int):
    """(batch, 1, seconds) chunks of a synthetic file at a step of a tenth
    of a chunk, host float32."""
    audio = synth(minutes, seed=seed)
    n = int(seconds * SAMPLE_RATE)
    step = n // 10
    return np.stack([audio[i * step:i * step + n]
                     for i in range(batch)])[:, None]


def calibrate_powerset(model, x: torch.Tensor) -> float:
    """Centre each logit of a random powerset head on its median over
    ``x`` and scale it to SEP_LOGIT_SPREAD (float32 throughout), so that
    the argmax moves with the audio: a random head settles on one class
    everywhere (the seeded model's 10-minute file had no speech). Returns
    the largest gain: a difference in the head's input is that many times
    larger in the logits after it."""
    logits = []
    hook = model.classifier.register_forward_hook(
        lambda module, args, out: logits.append(out))
    try:
        with torch.inference_mode(), lstm_precision_env("highest"):
            model(x)
    finally:
        hook.remove()
    logit = logits[0].flatten(0, 1).double()
    gain = SEP_LOGIT_SPREAD / logit.std(0)
    with torch.no_grad():
        head = model.classifier
        head.weight.mul_(gain[:, None].float())
        head.bias.sub_(logit.median(0).values.float()).mul_(gain.float())
    return float(gain.max())


def check_sseriouss(device, workdir: Path, card: str) -> int:
    """(v) SSeRiouSS: one batch card vs CPU, then SpeakerDiarization on 10
    + 3 min through apply_batch (warm wall, exact LSTM launches, peak);
    returns the launches."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.sseriouss import \
        SSeRiouSS
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    model = SSeRiouSS(generator=torch.Generator().manual_seed(50)).eval()
    chunks = chunk_batch(1.0, SSL_CHUNK_SECONDS, SSL_BATCH, seed=51)
    x = torch.from_numpy(chunks).to(device)
    cpu_x = torch.from_numpy(chunks[:SSL_CPU_CHUNKS])
    # made to mark speech as (n)'s PyanNet is (the seeded model settles on
    # "no speaker" everywhere): the BiLSTM and linear weights at
    # ML_WEIGHT_SCALE x their bound, the head calibrated
    model.to(device)
    with torch.no_grad():
        for name, p in model.lstm.named_parameters():
            if name.startswith("weight"):
                p.mul_(ML_WEIGHT_SCALE)
        for layer in model.linear:
            layer.weight.mul_(ML_WEIGHT_SCALE)
    calibrate_powerset(model, torch.from_numpy(chunk_batch(
        0.5, SSL_CHUNK_SECONDS, 16, seed=52)).to(device))
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        start = time.perf_counter()
        logp_cpu = cpu_model(cpu_x)
        cpu_seconds = time.perf_counter() - start
        for precision, atol in (("highest", REFERENCE_LOGP_ATOL),
                                ("default", SSL_DEFAULT_LOGP_ATOL)):
            with lstm_precision_env(precision):
                reset_lstm()
                logp = model(x)
                launches = lstm_launches()
                ms = cuda_ms(lambda: model(x), runs=3, warmup=1)
            logp_card = logp[:SSL_CPU_CHUNKS].float().cpu()
            err = (logp_card - logp_cpu).abs().max().item()
            log(f"(v) SSeRiouSS ({precision}) one batch {tuple(x.shape)} -> "
                f"{tuple(logp.shape)}: {ms:.3f} ms per batch on the card "
                f"(median of 3; {card}), {launches} LSTM launches; "
                f"log-probs card vs the CPU's {SSL_CPU_CHUNKS} rows "
                f"({cpu_seconds:.1f} s): max_abs_err {err:.3e} (limit "
                f"{atol}); they spread by {logp.std((0, 1)).min().item():.3f}"
                f" or more")
            if launches != 4:
                raise AssertionError("(v) SSeRiouSS's BiLSTM did not launch "
                                     "the kernel once per layer")
            if not (torch.isfinite(logp).all() and err <= atol):
                raise AssertionError(f"(v) SSeRiouSS ({precision}) disagrees "
                                     f"with the CPU")
            if precision == "default":
                hold_powerset("(v) log-probs card vs CPU (default)",
                              logp_card, logp_cpu)
    del x, logp, cpu_model
    files = write_files(workdir, FILE_MINUTES)
    set_gates(None)
    pipeline = SpeakerDiarization(
        segmentation=model,
        embedding=WeSpeakerResNet34(generator=torch.Generator()
                                    .manual_seed(2)),
        segmentation_batch_size=SSL_BATCH, embedding_batch_size=BATCH_SIZE,
        device=device)
    pipeline.instantiate(PARAMS)
    run_batch(pipeline, files)                                  # warm
    torch.cuda.synchronize()
    reset_counts(pipeline)
    peak, wall = peak_and_wall(device, lambda: check_outputs(
        files, run_batch(pipeline, files)))
    counts = read_counts(pipeline)
    expected = 4 * len(segmentation_batches(
        FILE_MINUTES, SSL_CHUNK_SECONDS, SSL_BATCH))
    log(f"(v) SSeRiouSS diarization, {' + '.join(map(str, FILE_MINUTES))} "
        f"min through apply_batch: "
        f"counts {counts} (LSTM launches expected {expected}); warm pass "
        f"{wall:.3f} s = {wall * 60 / sum(FILE_MINUTES):.3f} s per "
        f"audio-hour; peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated; {card})")
    if counts["lstm_launches"] != expected:
        raise AssertionError("(v) the SSeRiouSS pass did not launch the "
                             "LSTM kernel once per layer and batch")
    return counts["lstm_launches"]


def make_totatonet(device, wavlm_layers: int = None):
    """ToTaToNet at its defaults with the WAVLM_LARGE branch (its published
    widths; ``wavlm_layers`` of its 24 layers when given), seeded, on
    ``device``."""
    from pyannote_audio_tpu_torch.models.segmentation.sseriouss import \
        SSL_CONFIGS
    from pyannote_audio_tpu_torch.models.separation.totatonet import \
        ToTaToNet
    config = dict(SSL_CONFIGS["WAVLM_LARGE"])
    if wavlm_layers is not None:
        config["layers"] = wavlm_layers
    model = ToTaToNet(use_wavlm=True, wavlm_config=config,
                      generator=torch.Generator().manual_seed(60))
    return model.eval().to(device)


def calibrate_sigmoid(model, x: torch.Tensor) -> None:
    """Centre a random diarization head's logits on their median over
    ``x`` and scale them to SEP_LOGIT_SPREAD (float32 throughout): at
    init its scores are 0.5 within about 1e-2, a near tie everywhere."""
    with torch.inference_mode(), lstm_precision_env("highest"):
        logit = torch.logit(model(x)[0].double().flatten())
    gain = SEP_LOGIT_SPREAD / logit.std()
    with torch.no_grad():
        head = model.classifier
        head.weight.mul_(gain.float())
        head.bias.sub_(logit.median().float()).mul_(gain.float())


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def separation_pipeline(model, device):
    from pyannote_audio_tpu_torch.pipelines.speech_separation import \
        SpeechSeparation
    pipeline = SpeechSeparation(model, segmentation_batch_size=SEP_BATCH,
                                device=device)
    return pipeline.instantiate(SEP_PARAMS)


def traced_separation(pipeline, file: dict) -> tuple:
    """(output, {"clusters": hard clusters, "binarized": binarized chunk
    scores, "chunks": their sliding window, "scores": chunk scores}) of
    one run."""
    seen = {}
    klass = type(pipeline.clustering)
    original = klass.__call__

    def capture(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        seen["clusters"] = np.array(out[0])
        seen["binarized"] = np.array(kwargs["segmentations"].data)
        seen["chunks"] = kwargs["segmentations"].sliding_window
        return out

    def hook(name, artifact, file=None, total=None, completed=None):
        if name == "segmentation" and artifact is not None:
            seen["scores"] = np.array(artifact.data)
    klass.__call__ = capture
    try:
        output = pipeline(dict(file), max_speakers=4, hook=hook)
    finally:
        klass.__call__ = original
    return output, seen


def hold_separation(ours, seen_ours: dict, theirs, seen_theirs: dict,
                    frame: float) -> None:
    """Hold the card's SpeechSeparation run (``ours``, with what
    ``traced_separation`` saw) to the CPU's (``theirs``): binarized
    scores that differ must be near ties; outside the chunks they touch,
    equal hard clusters, annotations (boundaries within ``frame``) and
    sources (relative L2)."""
    differ = (seen_ours["binarized"] != seen_theirs["binarized"])
    touched = differ.any(axis=(1, 2))
    cpu_scores = seen_theirs["scores"]
    err = np.abs(seen_ours["scores"] - cpu_scores).max()
    threshold = SEP_PARAMS["segmentation"]["threshold"]
    near = np.abs(cpu_scores - threshold) <= 2 * err
    log(f"(w) SpeechSeparation on {SEP_SHORT_SECONDS:g} s, card (highest) "
        f"vs CPU: diarization scores max_abs_err {err:.3e}; "
        f"{int(differ.sum())} binarized values differ, "
        f"{int((differ & ~near).sum())} of them farther than twice that "
        f"from the threshold (limit 0); {int(touched.sum())} of "
        f"{len(touched)} chunks touched")
    if (differ & ~near).any():
        raise AssertionError("(w) the card binarizes otherwise than the "
                             "CPU away from the threshold")
    if not np.array_equal(seen_ours["clusters"][~touched],
                          seen_theirs["clusters"][~touched]):
        raise AssertionError("(w) hard clusters differ outside the chunks "
                             "a near tie touches")
    # outside the touched chunks (widened by two frames, and the sources
    # also by the leakage mask's collar) the discrete diarization is the
    # same, so the same annotations (boundaries within one frame) and
    # sources; with no chunk touched, that is the whole file
    chunks_sw = seen_ours["chunks"]
    spans = [(chunks_sw.start + i * chunks_sw.step - 2 * frame,
              chunks_sw.start + i * chunks_sw.step + chunks_sw.duration
              + 2 * frame) for i in np.flatnonzero(touched)]

    def outside(annotation):
        return [(seg, label) for seg, _, label in
                annotation.itertracks(yield_label=True)
                if all(seg.end <= a or seg.start >= b for a, b in spans)]
    ta = outside(ours.speaker_diarization)
    tb = outside(theirs.speaker_diarization)
    same = ours.speaker_diarization.labels() == \
        theirs.speaker_diarization.labels() and len(ta) == len(tb) and all(
            la == lb and abs(sa.start - sb.start) <= frame
            and abs(sa.end - sb.end) <= frame
            for (sa, la), (sb, lb) in zip(ta, tb))
    collar = SEP_PARAMS["separation"]["asr_collar"]
    held = np.ones(ours.sources.shape[0], dtype=bool)
    for a, b in spans:
        held[max(0, int((a - collar) * SAMPLE_RATE)):
             max(0, int(np.ceil((b + collar) * SAMPLE_RATE)))] = False
    comparable = ours.sources.shape == theirs.sources.shape
    whole = rel_l2(ours.sources, theirs.sources) if comparable else np.inf
    rel = np.inf if not comparable else (
        rel_l2(ours.sources[held], theirs.sources[held]) if held.any()
        else 0.0)
    log(f"(w) outside the touched chunks: {len(ta)} vs {len(tb)} segments, "
        f"labels {ours.speaker_diarization.labels()} vs "
        f"{theirs.speaker_diarization.labels()}, boundaries within one "
        f"frame: {same}; sources {ours.sources.shape} vs "
        f"{theirs.sources.shape}, relative L2 {rel:.3e} over "
        f"{int(held.sum())} of {len(held)} samples (limit "
        f"{SEP_SOURCES_REL_L2}), {whole:.3e} over the whole file")
    if not (same and rel <= SEP_SOURCES_REL_L2):
        raise AssertionError("(w) SpeechSeparation on the card differs "
                             "from the CPU's outside the chunks a near tie "
                             "touches")


def check_separation(device, workdir: Path, card: str) -> int:
    """(w) ToTaToNet + WavLM-large: one batch card vs CPU in "highest"
    and "default", Inference's tuple, SpeechSeparation on 3 min (warm
    wall, exact LSTM launches, peak, sources), and the card's pipeline on
    a short file against the CPU's; returns the launches."""
    import math

    from pyannote_audio_tpu_torch.core.inference import (Inference,
                                                         _chunk_grid)
    from pyannote_audio_tpu_torch.core.io import write_wav
    model = make_totatonet(device)
    cpu_model = copy.deepcopy(model).to("cpu")
    chunks = chunk_batch(1.0, SEP_CHUNK_SECONDS, SEP_BATCH, seed=62)
    # the seeded model as it is, then with its head calibrated
    with torch.inference_mode():
        start = time.perf_counter()
        diar_cpu, src_cpu = (o.numpy() for o in cpu_model(
            torch.from_numpy(chunks[:SEP_CPU_CHUNKS])))
        cpu_seconds = time.perf_counter() - start
        x = torch.from_numpy(chunks).to(device)
        for precision, diar_atol, src_rel in (
                ("highest", SEP_DIAR_ATOL, SEP_SOURCES_REL_L2),
                ("default", SEP_DEFAULT_DIAR_ATOL,
                 SEP_DEFAULT_SOURCES_REL_L2)):
            with lstm_precision_env(precision):
                reset_lstm()
                diar, src = model(x)
                launches = lstm_launches()
                ms = cuda_ms(lambda: model(x), runs=3, warmup=1)
            d = diar[:SEP_CPU_CHUNKS].cpu().numpy()
            sr = src[:SEP_CPU_CHUNKS].cpu().numpy()
            err, rel = np.abs(d - diar_cpu).max(), rel_l2(sr, src_cpu)
            log(f"(w) ToTaToNet + WavLM-large as seeded ({precision}) "
                f"one batch "
                f"{tuple(x.shape)} -> diarization {tuple(diar.shape)}, "
                f"sources {tuple(src.shape)}: {ms:.3f} ms per batch on the "
                f"card (median of 3; {card}), {launches} LSTM launches; "
                f"against the CPU's {SEP_CPU_CHUNKS} rows ({cpu_seconds:.1f}"
                f" s): diarization max_abs_err {err:.3e} (limit "
                f"{diar_atol}), sources relative L2 {rel:.3e} (limit "
                f"{src_rel})")
            if not (np.isfinite(d).all() and np.isfinite(sr).all()
                    and err <= diar_atol and rel <= src_rel
                    and launches == 12):
                raise AssertionError(f"(w) ToTaToNet ({precision}) "
                                     f"disagrees with the CPU")
    calibrate_sigmoid(model, torch.from_numpy(chunk_batch(
        0.5, SEP_CHUNK_SECONDS, 16, seed=61)).to(device))
    cpu_model.classifier.load_state_dict(model.classifier.state_dict())
    with torch.inference_mode(), lstm_precision_env("highest"):
        diar = model(x[:2])[0].cpu().numpy()
        diar_cpu = cpu_model(torch.from_numpy(chunks[:2]))[0].numpy()
    err = np.abs(diar - diar_cpu).max()
    log(f"(w) the head calibrated: diarization card vs CPU (highest) "
        f"max_abs_err {err:.3e} (limit {SEP_DIAR_ATOL}), scores spread by "
        f"{diar.std():.3f}")
    if not (np.isfinite(diar).all() and err <= SEP_DIAR_ATOL):
        raise AssertionError("(w) the calibrated ToTaToNet disagrees with "
                             "the CPU")
    del x, diar, src
    torch.cuda.empty_cache()

    short = workdir / f"synth_sep_{SEP_SHORT_SECONDS:g}_s.wav"
    write_wav(short, synth(SEP_SHORT_SECONDS / 60, seed=63)[None],
              SAMPLE_RATE)
    short = {"audio": str(short), "uri": "short"}
    out = Inference(model, batch_size=SEP_BATCH, device=device)(dict(short))
    if not (isinstance(out, tuple) and len(out) == 2
            and out[0].data.shape[1:] == (model.num_frames(80000), 3)
            and out[1].data.shape[1:] == (80000, 3)
            and all(np.isfinite(o.data).all() for o in out)):
        raise AssertionError("(w) Inference(ToTaToNet) did not return the "
                             "(diarization, sources) tuple")
    log(f"(w) Inference(ToTaToNet) on {SEP_SHORT_SECONDS:g} s: "
        f"{out[0].data.shape} diarization, {out[1].data.shape} sources")

    file = {"audio": str(workdir / "synth_sep_3_min.wav"), "uri": "sep"}
    write_wav(file["audio"], synth(SEP_MINUTES, seed=64)[None], SAMPLE_RATE)
    pipeline = separation_pipeline(model, device)
    pipeline(dict(file), max_speakers=4)                        # warm
    torch.cuda.synchronize()
    reset_lstm()
    output = {}
    peak, wall = peak_and_wall(device, lambda: output.update(
        out=pipeline(dict(file), max_speakers=4)))
    output = output["out"]
    launches = lstm_launches()
    starts, _ = _chunk_grid(int(SEP_MINUTES * 60 * SAMPLE_RATE),
                            int(SEP_CHUNK_SECONDS * SAMPLE_RATE),
                            int(SEP_CHUNK_SECONDS * SAMPLE_RATE) // 10)
    expected = 12 * math.ceil(len(starts) / SEP_BATCH)
    sources = output.sources
    log(f"(w) SpeechSeparation on {SEP_MINUTES:g} min: warm pass {wall:.3f} "
        f"s = {wall * 60 / SEP_MINUTES:.3f} s per audio-hour; LSTM launches "
        f"{launches} (expected {expected}); peak device memory "
        f"{peak / 2**30:.3f} GiB; sources {sources.shape}, peak "
        f"{np.abs(sources).max():.4f}; {len(output.speaker_diarization)} "
        f"segments, labels {output.speaker_diarization.labels()} ({card})")
    if launches != expected or \
            sources.shape[0] != int(SEP_MINUTES * 60 * SAMPLE_RATE) or \
            not np.isfinite(sources).all() or \
            not len(output.speaker_diarization):
        raise AssertionError("(w) SpeechSeparation's pass is wrong")

    # the card's pipeline ("highest") against the CPU's on the short file
    with lstm_precision_env("highest"):
        ours, seen_ours = traced_separation(pipeline, short)
        theirs, seen_theirs = traced_separation(
            separation_pipeline(cpu_model, "cpu"), short)
    hold_separation(ours, seen_ours, theirs, seen_theirs,
                    model.receptive_field.step)
    return launches


def phase_separation(device, workdir: Path, card: str) -> dict:
    """Phase 10: SSeRiouSS diarization (v) and speech separation (w);
    returns the LSTM launches of each path."""
    log(f"phase 10, SSeRiouSS and speech separation, on {card}")
    return {"SSeRiouSS diarization (v)": check_sseriouss(device, workdir,
                                                          card),
            "speech separation (w)": check_separation(device, workdir,
                                                       card)}


# -- phase 3 under autograd and phase 11 -------------------------------------

# phase 3 under autograd: the backward kernel against the plain backward
# (``lstm_bidirectional_recurrence_backward_plain``, float32 TF32 off) at
# every training shape, grad_xw and grad_w_hh each within BACKWARD_RTOL
# relative L2 (float32 sums in another order: grad_w_hh sums T x B terms,
# 1.0e-05 apart at (100, 3264) on an H100), finite, one counted launch
# and no forward launch counted. Then LSTMRecurrence (kernel forward,
# backward kernel) against the all-plain autograd on the card at the
# training shape (T = 589, B = 32: batches of 32 ten-second chunks) and a
# ragged B.
# "highest": forward 1e-4 as above, gradients 1e-4 relative L2 (float32
# sums in another order). "default": forward 1e-3 as above; the all-plain
# autograd at "default" differentiates the bf16-rounded products while the
# Function's backward is the float32 VJP, as the JAX package's
# ("highest" gradients at the same inputs): their gradients part by about
# bf16's rounding (2.1e-03 relative L2 at most on an H100), bounded at 1e-2.
# In "highest" the two backwards are the same computation on the same
# inputs
TRAIN_SHAPES = (("B=32 layer 0", 589, 32, 60), ("B=32 layer 1", 589, 32, 256),
                ("B=7 layer 0", 589, 7, 60), ("B=16 layer 1", 589, 16, 256))
# PixIT's (z): the DPRNN's intra-chunk (T = chunk size, B = chunks x 102
# folds) and inter-chunk (T = 102 folds, B = chunks x 100 frames) BiLSTMs
# at a batch of 32 five-second chunks and at 31 (phase 10's shapes), and at
# (z)'s training batch of 16, each held and timed under autograd as the
# training shape
DPRNN_TRAIN_SHAPES = (("DPRNN intra", 100, 3264, 128),
                      ("DPRNN inter", 102, 3200, 128),
                      ("DPRNN intra tail", 100, 3162, 128),
                      ("DPRNN inter tail", 102, 3100, 128),
                      ("DPRNN intra B=16", 100, 1632, 128),
                      ("DPRNN inter B=16", 102, 1600, 128))
# the edges of the backward kernel's geometry (``backward_geometry``), held
# like the training shapes: B on each side of each step of its rows per
# cluster at H = 128 (8 -> 16 -> 32 -> 64 at B = 64 / 65, 128 / 129,
# 256 / 257), B = 1, T = 1 and 2, H = 8 (one CTA), 17 (two), 100 (eight,
# padded), 200 and 256 (32 units a CTA, A in shared memory), one direction
BACKWARD_EDGE_SHAPES = (("B=64", 50, 64, 128, 2), ("B=65", 50, 65, 128, 2),
                        ("B=128", 50, 128, 128, 2),
                        ("B=129", 50, 129, 128, 2),
                        ("B=256", 50, 256, 128, 2),
                        ("B=257", 50, 257, 128, 2),
                        ("B=1 T=1", 1, 1, 128, 2), ("T=2", 2, 3, 128, 2),
                        ("B=1 H=17", 40, 1, 17, 2), ("H=8", 30, 5, 8, 2),
                        ("H=100", 40, 6, 100, 2), ("H=200", 40, 6, 200, 2),
                        ("H=256 one direction", 20, 70, 256, 1),
                        ("one direction", 30, 7, 128, 1))
AUTOGRAD_GRAD_RTOL = {"highest": 1e-4, "default": 1e-2}
BACKWARD_RTOL = 1e-4
# (x) one step card against CPU on the exact path: the loss within 1e-5
# relative (float32 sums in another order), each gradient within 1e-3
# relative L2 against the larger of its own norm and 1e-6 of the whole
# gradient's (the SincNet conv biases before an instance norm have a true
# gradient of zero, of which both sides give rounding noise); SincNet's
# within TRAIN_SINC_GRAD_RTOL: they are ill-conditioned in float32 (the
# first H100 run measured up to 1.24e-2 between card and CPU; the CPU
# tests 2.6e-2 between the JAX package and the port), and the check prints
# how far they move when the waveform moves by about 2 ulp. That this is
# rounding, not a different gradient, is held in float64: the SincNet
# block's gradients for one seeded upstream gradient, card against CPU,
# within SINC_F64_GRAD_RTOL (the CPU tests hold the port's float64
# gradients to the JAX package's at 1e-9, measured 1.8e-11). After 3 Adam
# steps (lr 1e-3) every parameter within 2 * lr * steps: a component whose
# gradient is rounding noise may move by up to lr either way each step, as
# the SincNet conv biases before an instance norm (a true gradient of
# zero) and some filter edges (their gradients cancel by up to 1e5 over
# the taps) do, so SincNet's tensors are not held one by one (their
# updates part by 0.70-1.37 relative L2 on an H100). The update of each
# parameter outside SincNet within TRAIN_PARAM_UPDATE_RTOL relative L2
# (measured up to 5.3e-3) and the model's within TRAIN_UPDATE_RTOL
# (measured 1.06e-2)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
TRAIN_SINC_GRAD_RTOL = 5e-2
SINC_F64_GRAD_RTOL = 1e-9
TRAIN_UPDATE_RTOL = 5e-2
TRAIN_PARAM_UPDATE_RTOL = 2e-2
TRAIN_LR = 1e-3
# (x) the run: 2 epochs of 5 steps of 32 ten-second chunks over 6 train
# files of 9 minutes (2-4 speakers each, with overlap) and a 6-minute
# development file (36 chunks: validation batches of 32 and 4)
TRAIN_FILES, TRAIN_FILE_MINUTES, DEV_MINUTES = 6, 9.0, 6.0
TRAIN_EPOCHS, TRAIN_STEPS, TRAIN_BATCH = 2, 5, 32
# resume_from epoch 0 against the uninterrupted run, on the card (cuDNN's
# conv backward is not bit-deterministic, so the two runs part by
# rounding): the resumed fit runs epoch 1 only and its Adam step counts
# equal the uninterrupted run's; every parameter within 2 * lr * steps
# (SincNet's noise components, as after 3 steps); the epoch-1 update of
# each parameter outside SincNet within RESUME_UPDATE_RTOL relative L2
# (measured up to 1.9e-2 on an H100), Adam's moments over the model within
# RESUME_MOMENT_RTOL (measured up to 5.5e-2 and 3.3e-3; a moment reset at
# the resume would part them by about 0.35 and 0.5), and the epoch-1 train
# loss within RESUME_LOSS_RTOL relative (measured 1.5e-5 to 4.3e-4)
RESUME_UPDATE_RTOL = 5e-2
RESUME_MOMENT_RTOL = {"exp_avg": 0.2, "exp_avg_sq": 3e-2}
RESUME_LOSS_RTOL = 2e-3
CHECKPOINT_LOGP_ATOL = 1e-6
SPEAKER_F0 = (140.0, 210.0, 320.0, 95.0)


def grad_rel_l2(ours: torch.Tensor, theirs: torch.Tensor,
                floor: float = 0.0) -> float:
    ours, theirs = ours.double().cpu(), theirs.double().cpu()
    return float((ours - theirs).norm() / max(float(theirs.norm()), floor,
                                              1e-30))


def update_errors(ours: dict, theirs: dict, start: dict) -> dict:
    """{name: relative L2 of ``ours``' update from ``start`` against
    ``theirs``'} for every parameter, and the worst of each module's."""
    errors = {n: grad_rel_l2(ours[n].cpu() - start[n].cpu(),
                             theirs[n].cpu() - start[n].cpu())
              for n in start}
    worst = {}
    for name, value in errors.items():
        key = name.split(".")[0]
        if value >= worst.get(key, ("", -1.0))[1]:
            worst[key] = (name, value)
    return worst


def lstm_backward_bound(T, B, H, D) -> dict:
    """Least time of ``LSTMRecurrence``'s backward on an H100 SXM at 700 W,
    operations against bytes (xw and the output's gradient read, xw's
    gradient written, W_hh read and its gradient written, once each, over
    3.35 TB/s). The work is the float32 recurrence recomputed (its
    recurrent product, 2*T*B*D*4H*H), the walk's product for the hidden
    state's gradient (as many) and W_hh's gradient (as many).
    ``backward_bound_ms`` is the route the kernel takes: its two products
    as three TF32 passes at 495 TFLOP/s dense on the tensor cores, W_hh's
    gradient at 67 TFLOP/s float32 (TF32 off); ``backward_bound_f32_ms``
    all three at 67 TFLOP/s, as float32 FMA on the CUDA cores."""
    moved = 4 * (2 * T * B * D * 4 * H + T * B * D * H + 2 * D * 4 * H * H)
    product = 2 * T * B * D * 4 * H * H
    bytes_ms = moved / 3.35e12 * 1e3
    ops_ms = (2 * 3 * product / 495e12 + product / 67e12) * 1e3
    f32_ms = 3 * product / 67e12 * 1e3
    return {"backward_bound_ms": max(bytes_ms, ops_ms),
            "backward_bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations",
            "backward_bound_f32_ms": max(bytes_ms, f32_ms)}


def backward_parts(device, T, B, D_in) -> dict:
    """The backward's parts at one BiLSTM layer (H = 128), CUDA events,
    medians of 10: the kernel's recompute alone (phases 1) and its walk
    alone (phases 2), the W_hh product as ``lstm_recurrence_backward``
    takes it, the whole call, and cuDNN's float32 layer backward on the
    same shape; ms each. The parts' launches are not counted."""
    from pyannote_audio_tpu_torch.ops import lstm_kernel
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    H, D = 128, 2
    xw, w_hh, (x, _, _) = layer_inputs(device, T, B, D_in, H, D, seed=B)
    grad = torch.randn(T, B, D * H, device=device)
    geometry = lstm_kernel.backward_geometry(H, B, D)
    packed = lstm_kernel.pack_backward_weights(w_hh, geometry)
    ws = torch.empty((T, B, D, 5 * H), device=device)
    h_prev = torch.empty((D, T, B, H), device=device)
    grad_xw = torch.empty_like(xw)

    def part(phases):
        return lambda: lstm_kernel._launch_backward(
            xw, grad, packed, geometry, ws, h_prev, grad_xw, phases)

    row = {"recompute_ms": cuda_ms(part(1), runs=10),
           "walk_ms": cuda_ms(part(2), runs=10),
           "product_ms": cuda_ms(lambda: lstm_kernel.grad_w_hh_product(
               grad_xw, h_prev), runs=10),
           "whole_ms": cuda_ms(lambda: lstm_kernel.lstm_recurrence_backward(
               xw, w_hh, grad), runs=10),
           "rows": geometry["rows"], "cluster": geometry["cluster"]}
    del ws, h_prev, grad_xw
    lstm = torch.nn.LSTM(D_in, H, bidirectional=True).to(device)
    lstm.flatten_parameters()
    xin = x.detach().clone().requires_grad_()
    with exact_float32():
        y, _ = lstm(xin)
        row["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, [xin, *lstm.parameters()], grad, retain_graph=True), runs=10)
    return row


def autograd_of_plain(xw, w_hh, grad):
    """The Function's backward before the backward kernel: the plain
    recurrence recomputed at "highest" under autograd, and its VJP."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    a = xw.detach().requires_grad_()
    b = w_hh.detach().requires_grad_()
    with torch.enable_grad(), exact_float32():
        out = lstm_bidirectional_recurrence_plain(a, b, "highest")
        return torch.autograd.grad(out, (a, b), grad)


def autograd_timings(device, T, B, D_in, old_backward: bool = True,
                     H: int = 128) -> dict:
    """One BiLSTM layer (H = 128 unless given) under autograd, CUDA events:
    the kernel
    forward ("default", median of 20) and its bound; the Function's
    backward per layer, the backward kernel (median of 10), with its
    bound and the bytes it allocates at its peak (the workspace, the
    recomputed h and the gradients); the plain backward and, where
    ``old_backward``, the plain recurrence's autograd (the backward
    before the kernel, kept for the record, else None), medians of 3;
    the plain forward ("default", median of 3); cuDNN's float32 layer
    backward and forward + backward (medians of 10); the row's wall."""
    from pyannote_audio_tpu_torch.ops.lstm import (
        lstm_bidirectional_recurrence_backward_plain,
        lstm_bidirectional_recurrence_plain)
    from pyannote_audio_tpu_torch.ops.lstm_kernel import (
        LSTMRecurrence, lstm_bidirectional_recurrence,
        prepare_recurrent_weights)
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    start = time.perf_counter()
    D = 2
    xw, w_hh, (x, w_ih, b) = layer_inputs(device, T, B, D_in, H, D)
    prepared = prepare_recurrent_weights(w_hh, "default")
    grad = torch.randn(T, B, D * H, device=device)
    kernel_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
        xw, w_hh, "default", prepared), runs=20)
    plain_ms = cuda_ms(lambda: lstm_bidirectional_recurrence_plain(
        xw, w_hh, "default"), runs=3, warmup=1)
    a = xw.detach().clone().requires_grad_()
    w = w_hh.detach().clone().requires_grad_()
    out = LSTMRecurrence.apply(a, w, "default", prepared)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (a, w), grad, retain_graph=True), runs=10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.autograd.grad(out, (a, w), grad, retain_graph=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    del out, a, w
    plain_backward_ms = cuda_ms(
        lambda: lstm_bidirectional_recurrence_backward_plain(xw, w_hh, grad),
        runs=3, warmup=1)
    autograd_plain_ms = cuda_ms(
        lambda: autograd_of_plain(xw, w_hh, grad), runs=3, warmup=1) \
        if old_backward else None
    packed = prepared.packed
    bound = lstm_bound(T, B, H, D, "default",
                       packed.numel() * packed.element_size())
    lstm = torch.nn.LSTM(D_in, H, bidirectional=True).to(device)
    lstm.flatten_parameters()
    xin = x.detach().clone().requires_grad_()
    g2 = torch.randn(T, B, D * H, device=device)

    def cudnn_step():
        y, _ = lstm(xin)
        y.backward(g2)

    with exact_float32():
        cudnn_ms = cuda_ms(cudnn_step, runs=10)
        y, _ = lstm(xin)
        cudnn_backward_ms = cuda_ms(lambda: torch.autograd.grad(
            y, [xin, *lstm.parameters()], g2, retain_graph=True), runs=10)
    return {"T": T, "B": B, "D_in": D_in, "H": H, "ms": kernel_ms,
            "plain_ms": plain_ms, "backward_ms": backward_ms,
            "backward_peak_bytes": peak,
            "workspace_bytes": T * B * D * 5 * H * 4,
            "plain_backward_ms": plain_backward_ms,
            "autograd_plain_backward_ms": autograd_plain_ms,
            "library_fwd_bwd_ms": cudnn_ms,
            "library_bwd_ms": cudnn_backward_ms, **bound,
            **lstm_backward_bound(T, B, H, D),
            "wall_s": time.perf_counter() - start}


def log_autograd_timings(name: str, row: dict) -> None:
    log(f"{name} ({row['T']}, {row['B']}, {4 * 2 * row['H']}) -> "
        f"({row['T']}, {row['B']}, {2 * row['H']}), D_in {row['D_in']}: "
        f"kernel forward "
        f"{row['ms']:.3f} ms (bound {row['bound_ms']:.4f} ms, "
        f"{row['bound_by']}), the Function's backward (the backward kernel) "
        f"{row['backward_ms']:.3f} ms per layer (bound "
        f"{row['backward_bound_ms']:.4f} ms on its route, "
        f"{row['backward_bound_by']}, {row['backward_bound_f32_ms']:.4f} ms "
        f"all float32 on the CUDA cores; "
        f"peak {row['backward_peak_bytes'] / 2**20:.1f} MiB allocated, "
        f"the workspace {row['workspace_bytes'] / 2**20:.1f} MiB), plain "
        f"backward {row['plain_backward_ms']:.1f} ms, "
        + (f"the plain recurrence's autograd (the backward before the "
           f"kernel) {row['autograd_plain_backward_ms']:.1f} ms, "
           if row["autograd_plain_backward_ms"] is not None else "")
        + f"plain forward {row['plain_ms']:.1f} ms; cuDNN torch.nn.LSTM "
        f"float32 backward {row['library_bwd_ms']:.3f} ms, forward + "
        f"backward {row['library_fwd_bwd_ms']:.3f} ms per layer; "
        f"{row['wall_s']:.1f} s of wall")


def check_backward_kernel(name, T, B, xw, w_hh, grad) -> dict:
    """The backward kernel against the plain backward at one shape:
    {"xw", "w_hh": relative L2, "max_abs"}; raises past BACKWARD_RTOL,
    on a non-finite gradient, or unless it counted one backward launch
    and no forward one."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_backward_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_recurrence_backward
    reset_lstm()
    gx, gw = lstm_recurrence_backward(xw, w_hh, grad)
    torch.cuda.synchronize()
    counted = (lstm_launches(), backward_launches())
    rx, rw = lstm_bidirectional_recurrence_backward_plain(xw, w_hh, grad)
    # grad_w_hh is 0 where T = 1 (h_prev is 0): relative to 1e-30 then
    errs = {"xw": grad_rel_l2(gx, rx), "w_hh": grad_rel_l2(gw, rw),
            "max_abs": max(float((gx - rx).abs().max()),
                           float((gw - rw).abs().max()))}
    log(f"lstm_recurrence_backward {name} (T={T}, B={B}): relative L2 "
        f"grad_xw {errs['xw']:.3e}, grad_w_hh {errs['w_hh']:.3e} (limit "
        f"{BACKWARD_RTOL}), max_abs {errs['max_abs']:.3e}; launches "
        f"(forward, backward) {counted}")
    if not (torch.isfinite(gx).all() and torch.isfinite(gw).all()
            and errs["xw"] <= BACKWARD_RTOL and errs["w_hh"] <= BACKWARD_RTOL
            and counted == (0, 1)):
        raise AssertionError(f"the backward kernel disagrees with the plain "
                             f"backward at {name}: {errs}, {counted}")
    return errs


def hold_recurrence_autograd(name, T, B, xw, w_hh, grad, worst) -> None:
    """LSTMRecurrence (the kernel forward, the backward kernel) against the
    all-plain autograd at one shape in "highest" and "default": the
    forward within KERNEL_ATOL, the gradients within AUTOGRAD_GRAD_RTOL;
    ``worst[precision]`` keeps the largest errors. Raises past a limit."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import LSTMRecurrence
    for precision, limit in AUTOGRAD_GRAD_RTOL.items():
        runs = []
        for fn in (lambda a, b: LSTMRecurrence.apply(a, b, precision),
                   lambda a, b: lstm_bidirectional_recurrence_plain(
                       a, b, precision)):
            a = xw.detach().clone().requires_grad_()
            b = w_hh.detach().clone().requires_grad_()
            out = fn(a, b)
            out.backward(grad)
            runs.append((out.detach(), a.grad, b.grad))
            del out
        torch.cuda.synchronize()
        (out, gx, gw), (ref, rx, rw) = runs
        errs = {"forward": (out - ref).abs().max().item(),
                "xw": grad_rel_l2(gx, rx), "w_hh": grad_rel_l2(gw, rw)}
        for key, value in errs.items():
            worst[precision][key] = max(worst[precision][key], value)
        log(f"LSTMRecurrence {precision:8s} {name} (T={T}, B={B}): "
            f"forward max_abs_err {errs['forward']:.3e} (limit "
            f"{KERNEL_ATOL[precision]}), gradient relative L2 xw "
            f"{errs['xw']:.3e}, w_hh {errs['w_hh']:.3e} (limit {limit})")
        if not (torch.isfinite(gx).all() and torch.isfinite(gw).all()
                and errs["forward"] <= KERNEL_ATOL[precision]
                and errs["xw"] <= limit and errs["w_hh"] <= limit):
            raise AssertionError(
                f"LSTMRecurrence ({precision}) disagrees with the plain "
                f"autograd at {name}: {errs}")
        del runs, out, gx, gw, ref, rx, rw


def check_kernel_autograd(device: torch.device) -> dict:
    """The backward kernel against the plain backward, and LSTMRecurrence
    against the all-plain autograd, on the card at the segmentation
    training shapes, the DPRNN's and the edges of the backward kernel's
    geometry; the backward's parts at every training shape
    (``backward_parts``); the times of the training shape, a DDP rank's
    and each DPRNN shape (``autograd_timings``).
    Returns the training shape's row, with the backward kernel's record
    under "backward_kernel"."""
    H, D = 128, 2
    worst = {p: {"forward": 0.0, "xw": 0.0, "w_hh": 0.0}
             for p in AUTOGRAD_GRAD_RTOL}
    worst_backward = {"xw": 0.0, "w_hh": 0.0, "max_abs": 0.0}
    start = time.perf_counter()
    shapes = [(name, T, B, D_in, H, D) for name, T, B, D_in in
              TRAIN_SHAPES + DPRNN_TRAIN_SHAPES]
    shapes += [(name, T, B, 64, h, d)
               for name, T, B, h, d in BACKWARD_EDGE_SHAPES]
    # LSTMRecurrence where a training step runs it: (x)'s and (H)'s shapes
    # and (z)'s DPRNN at its batch of 16; the DPRNN's batch of 32 and its
    # tails (validation and serving run no backward) and the geometry's
    # edges hold the backward kernel alone
    trained = {name for name, *_ in TRAIN_SHAPES} | {
        name for name, *_ in DPRNN_TRAIN_SHAPES if "B=16" in name}
    for name, T, B, D_in, H, D in shapes:
        shape_start = time.perf_counter()
        xw, w_hh, _ = layer_inputs(device, T, B, D_in, H, D, seed=B)
        grad = torch.randn(T, B, D * H, device=device,
                           generator=torch.Generator(device).manual_seed(B))
        errs = check_backward_kernel(name, T, B, xw, w_hh, grad)
        for key, value in errs.items():
            worst_backward[key] = max(worst_backward[key], value)
        if name in trained:
            hold_recurrence_autograd(name, T, B, xw, w_hh, grad, worst)
        del xw, w_hh, grad
        log(f"  {name}: {time.perf_counter() - shape_start:.1f} s")
        torch.cuda.empty_cache()
    log(f"the checks under autograd at {len(TRAIN_SHAPES)} + "
        f"{len(DPRNN_TRAIN_SHAPES)} + {len(BACKWARD_EDGE_SHAPES)} shapes "
        f"took {time.perf_counter() - start:.1f} s")
    H, D = 128, 2

    # the backward's parts at every training shape, beside cuDNN's
    parts = {}
    for name, T, B, D_in in TRAIN_SHAPES + DPRNN_TRAIN_SHAPES:
        parts[name] = backward_parts(device, T, B, D_in)
        row = parts[name]
        log(f"backward parts {name} (T={T}, B={B}; rows per cluster "
            f"{row['rows']}, cluster {row['cluster']}): recompute "
            f"{row['recompute_ms']:.3f} ms, walk {row['walk_ms']:.3f} ms, "
            f"W_hh product {row['product_ms']:.3f} ms, the whole "
            f"backward {row['whole_ms']:.3f} ms; cuDNN float32 layer "
            f"backward {row['library_bwd_ms']:.3f} ms")
        torch.cuda.empty_cache()

    row = autograd_timings(device, 589, TRAIN_BATCH, 256)
    log_autograd_timings("training shape", row)
    # phase 14 (H): each DDP rank's share of the batch of 32
    rank_row = autograd_timings(device, 589, DDP_BATCH // DDP_WORLD, 256)
    log_autograd_timings("DDP rank shape", rank_row)
    dprnn = {}
    for name, T, B, D_in in DPRNN_TRAIN_SHAPES:
        # the intra shapes only: the inter and tail shapes time within 5 %
        # of them (their parts are timed above)
        if "intra" not in name or "tail" in name:
            continue
        dprnn[name] = autograd_timings(device, T, B, D_in)
        log_autograd_timings(name, dprnn[name])
        torch.cuda.empty_cache()
    backward = {
        "name": "lstm_recurrence_backward", "route": "cuda",
        "source": "pyannote_audio_tpu_torch/csrc/lstm_recurrence_backward.cu",
        "replaces": "pyannote_audio_tpu/ops/pallas_lstm.py:225",
        "launches": None, "max_abs_err": worst_backward["max_abs"],
        "grad_rel_l2": max(worst_backward["xw"], worst_backward["w_hh"]),
        "ms": row["backward_ms"], "plain_ms": row["plain_backward_ms"],
        "bound_ms": row["backward_bound_ms"],
        "bound_by": row["backward_bound_by"],
        "bound_f32_ms": row["backward_bound_f32_ms"],
        "parts": parts,
        "library_ms": row["library_bwd_ms"], "shape": [589, TRAIN_BATCH,
                                                      H, D],
        "autograd_plain_ms": row["autograd_plain_backward_ms"],
        "library_fwd_bwd_ms": row["library_fwd_bwd_ms"],
        "peak_bytes": row["backward_peak_bytes"],
        "ddp_rank": {k: rank_row[k] for k in (
            "backward_ms", "plain_backward_ms", "autograd_plain_backward_ms",
            "backward_bound_ms", "backward_bound_f32_ms", "library_bwd_ms",
            "backward_peak_bytes")},
        "dprnn": {n: {k: r[k] for k in (
            "backward_ms", "plain_backward_ms", "autograd_plain_backward_ms",
            "backward_bound_ms", "backward_bound_f32_ms", "library_bwd_ms",
            "backward_peak_bytes")}
            for n, r in dprnn.items()}}
    return {**row, "dprnn": dprnn, "ddp_rank": rank_row,
            "max_abs_err": {p: v["forward"] for p, v in worst.items()},
            "grad_rel_l2": {p: max(v["xw"], v["w_hh"])
                            for p, v in worst.items()},
            "backward_kernel": backward}


# the kernels' streamed route, above H = 256 (W_hh through shared memory,
# resident or streamed by bulk copies): the forward at T = 589 (10 s
# chunks), B = 32 (a training batch) and 256 (a serving batch), in every
# precision, at phase 4's H = 512 batch of 171 chunks (3 min) in every
# precision, and at H = 1024 with B = 8 in "default"; the backward (and
# LSTMRecurrence under autograd at 512) at (x)'s training batch of 32.
# Layer 0 of a PyanNet reads SincNet's 60 features (cuDNN's whole layer is
# timed over those, in WIDE_LIBRARY_ROUNDS rounds between the port's)
WIDE_HIDDEN = (257, 384, 512)
WIDE_BATCHES = (32, 256)
WIDE_PIPELINE_BATCH = (589, 171, 512)
WIDE_LARGEST = (589, 8, 1024)
WIDE_LIBRARY_ROUNDS = 3
WIDE_BACKWARD = ((589, 32, 384), (589, 32, 512))
WIDE_D_IN = 60
# the edges of the streamed geometry (``kernel_geometry``,
# ``backward_geometry``), held at T = WIDE_EDGE_T, (B, H): at H = 512, B
# astride each step of the rows, the cluster, the k-parts, the row tiles a
# warp (NTW), the resident / streamed switch and one wave / two, in every
# mode (the forward: 24 / 25 ... 336 / 337; the backward: 24 / 25 ...
# 120 / 121); H = 384 at R = 48 (NTW 2) and 64 (NTW 4, and "default"'s
# switch to a ring); H = 257 at 8 rows and at 64 (NTW 4); H = 768 at B =
# 168 / 169 ("default": clusters of 16 at R = 64, NTW 4); H = 1024 on
# clusters of 16 (B = 9, and 113: R = 48, NTW 3); and each cap (1792
# "default", 1408 "high" and "highest"; 2048 the backward). Together they
# reach every (mode, NTW) instantiation of the streamed forward and both
# cluster sizes in every mode (``check_wide_edges`` asserts it)
WIDE_EDGE_T = 24
WIDE_EDGES = tuple((B, 512) for B in (
    24, 25, 48, 49, 56, 57, 72, 73, 96, 97, 112, 113, 120, 121, 144, 145,
    168, 169, 192, 193, 224, 225, 336, 337)) + (
    (280, 384), (281, 384), (336, 384), (337, 384), (5, 257), (337, 257),
    (168, 768), (169, 768), (9, 1024), (113, 1024), (3, 1408), (3, 1792))
WIDE_BACKWARD_EDGES = ((24, 512), (25, 512), (48, 512), (49, 512),
                       (56, 512), (57, 512), (112, 512), (113, 512),
                       (120, 512), (121, 512), (5, 257), (3, 2048))
# the streamed forward's limits against its plain version: KERNEL_ATOL's,
# but 1e-5 for "highest" (three TF32 passes on this route; 1e-4 would
# pass a single TF32 pass, whose error tools/lstm_stream_parts.py reads
# as its control)
STREAM_ATOL = dict(KERNEL_ATOL, highest=1e-5)


def check_wide_edges(device: torch.device) -> dict:
    """Both streamed kernels at the edges of their geometry (WIDE_EDGES,
    WIDE_BACKWARD_EDGES), one launch each, against their plain versions:
    the forward in every mode within STREAM_ATOL (up to each mode's cap),
    the backward within BACKWARD_RTOL. Returns the largest errors; raises
    past a limit, unless each call launched its kernel once, or unless the
    edges reached every (mode, NTW) instantiation and both cluster sizes
    in every mode."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import (
        STREAM_CLUSTERS, STREAM_MAX_HIDDEN, STREAM_WARPS, backward_geometry,
        kernel_geometry, lstm_bidirectional_recurrence)
    T = WIDE_EDGE_T
    worst = dict.fromkeys(STREAM_ATOL, 0.0)
    reached = set()
    for B, H in WIDE_EDGES:
        xw, w_hh, _ = layer_inputs(device, T, B, WIDE_D_IN, H, 2, seed=B + H)
        for precision, limit in STREAM_ATOL.items():
            if H > STREAM_MAX_HIDDEN[precision]:
                continue
            g = kernel_geometry(H, precision, B, 2)
            reset_lstm()
            out = lstm_bidirectional_recurrence(xw, w_hh, precision)
            torch.cuda.synchronize()
            launched = lstm_launches()
            err = (out - lstm_bidirectional_recurrence_plain(
                xw, w_hh, precision)).abs().max().item()
            worst[precision] = max(worst[precision], err)
            reached |= {(precision, "ntw", g["ntw"]),
                        (precision, "cluster", g["cluster"])}
            log(f"lstm_recurrence {precision:8s} streamed edge (T={T}, B={B},"
                f" H={H}): cluster {g['cluster']}, rows {g['rows']}, NTW "
                f"{g['ntw']}, {g['kparts']} k-part(s), {g['resident']} of "
                f"{g['chunks']} chunks resident, {g['slots']} ring slots, "
                f"{g['waves']} wave(s); max_abs_err {err:.3e} (limit "
                f"{limit}), launches {launched}")
            if not (err <= limit and launched == 1):
                raise AssertionError(
                    f"the streamed forward kernel ({precision}) disagrees "
                    f"with its plain version at the edge B={B}, H={H}: "
                    f"{err} > {limit}, or launched {launched} times")
        del xw, w_hh
    missing = {(p, "ntw", n) for p in STREAM_ATOL for n in STREAM_WARPS} \
        | {(p, "cluster", c) for p in STREAM_ATOL for c in STREAM_CLUSTERS}
    missing -= reached
    if missing:
        raise AssertionError(f"the streamed forward's edges missed "
                             f"{sorted(missing)}")
    backward = {"xw": 0.0, "w_hh": 0.0, "max_abs": 0.0}
    for B, H in WIDE_BACKWARD_EDGES:
        xw, w_hh, _ = layer_inputs(device, T, B, WIDE_D_IN, H, 2, seed=B * H)
        grad = torch.randn(T, B, 2 * H, device=device,
                           generator=torch.Generator(device).manual_seed(B))
        g = backward_geometry(H, B, 2)
        errs = check_backward_kernel(
            f"streamed edge H={H} (cluster {g['cluster']}, rows "
            f"{g['rows']}, {g['stream_warps']} warps, {g['resident']} of "
            f"{g['chunks']} chunks resident, ring {g['ring']}, "
            f"{g['waves']} wave(s))", T, B, xw, w_hh, grad)
        for key, value in errs.items():
            backward[key] = max(backward[key], value)
        del xw, w_hh, grad
    torch.cuda.empty_cache()
    return {"forward_max_abs_err": worst, "backward": backward}


def fmt_ms(times) -> str:
    """Times in ms, each to the microsecond, joined by "/"."""
    return "/".join(f"{t:.3f}" for t in times)


def port_layer_ms(xw_inputs, w_hh, precision, prepared) -> float:
    """The port's whole BiLSTM layer as ``models/blocks/rnn.py`` runs it:
    the float32 input projection (TF32 off) and the recurrence kernel, ms
    (median of 5)."""
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    x, w_ih, b = xw_inputs

    def layer():
        with exact_float32():
            xw = (torch.matmul(x, w_ih.t()) + b).contiguous()
        return lstm_bidirectional_recurrence(xw, w_hh, precision, prepared)

    return cuda_ms(layer, runs=5, warmup=1)


def check_wide_kernels(device: torch.device) -> dict:
    """Both kernels' streamed route against their plain versions, timed
    beside their bounds, the plain versions and cuDNN's float32 layer:
    {"forward": rows, "backward": rows, "forward_max_abs_err",
    "backward_grad_rel_l2", "backward_max_abs_err", "autograd"}. Raises
    past a limit, or unless each call launched its kernel once."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import (
        kernel_geometry, lstm_bidirectional_recurrence,
        prepare_recurrent_weights, stream_cluster_capacity)
    start = time.perf_counter()
    shapes = [(589, B, H, tuple(STREAM_ATOL)) for H in WIDE_HIDDEN
              for B in WIDE_BATCHES] \
        + [WIDE_PIPELINE_BATCH + (tuple(STREAM_ATOL),),
           WIDE_LARGEST + (("default",),)]
    worst = dict.fromkeys(STREAM_ATOL, 0.0)
    forward = {}
    for T, B, H, modes in shapes:
        xw, w_hh, projection = layer_inputs(device, T, B, WIDE_D_IN, H, 2,
                                            seed=H)
        row = {"T": T, "B": B, "H": H}
        for precision in modes:
            geometry = kernel_geometry(H, precision, B, 2)
            # the geometry's waves, against the clusters the card holds
            capacity = stream_cluster_capacity(H, precision, B, 2)
            if geometry["waves"] != -(-geometry["clusters"] // capacity):
                raise AssertionError(
                    f"H={H}, B={B} ({precision}): {geometry['clusters']} "
                    f"clusters of {geometry['cluster']} take "
                    f"{geometry['waves']} wave(s) by kernel_geometry, but "
                    f"the card holds {capacity} at once")
            prepared = prepare_recurrent_weights(w_hh, precision)
            reset_lstm()
            out = lstm_bidirectional_recurrence(xw, w_hh, precision,
                                                prepared)
            torch.cuda.synchronize()
            launched = lstm_launches()
            ref = lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
            err = (out - ref).abs().max().item()
            del out, ref
            worst[precision] = max(worst[precision], err)
            limit = STREAM_ATOL[precision]
            ms = cuda_ms(lambda: lstm_bidirectional_recurrence(
                xw, w_hh, precision, prepared), runs=5, warmup=1)
            plain_ms = cuda_ms(lambda: lstm_bidirectional_recurrence_plain(
                xw, w_hh, precision), runs=1, warmup=0)
            layer_ms = port_layer_ms(projection, w_hh, precision, prepared)
            bound = lstm_bound(T, B, H, 2, precision,
                               prepared.packed.numel()
                               * prepared.packed.element_size())
            row[precision] = dict(ms=ms, plain_ms=plain_ms,
                                  layer_ms=layer_ms, max_abs_err=err,
                                  geometry={k: geometry[k] for k in (
                                      "cluster", "rows", "ntw", "kparts",
                                      "warps", "resident", "chunks",
                                      "slots", "waves")}, capacity=capacity,
                                  **bound)
            log(f"lstm_recurrence {precision:8s} streamed, H={H} "
                f"(cluster {geometry['cluster']} x {geometry['clusters']}, "
                f"the card holds {capacity}; rows {geometry['rows']}, "
                f"{geometry['warps']} warps of {geometry['ntw']} row tiles "
                f"in {geometry['kparts']} k-part(s), "
                f"{geometry['resident']} of {geometry['chunks']} chunks "
                f"resident, {geometry['slots']} ring slots) at (T={T}, "
                f"B={B}): max_abs_err {err:.3e} (limit {limit}), launches "
                f"{launched}; kernel {ms:.3f} ms (median of 5), the port's "
                f"layer (projection + kernel) {layer_ms:.3f} ms, bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})"
                + (f", {bound['bound_3xtf32_ms']:.4f} ms as 3xTF32"
                   if bound["bound_3xtf32_ms"] is not None else "")
                + f", plain {plain_ms:.1f} ms")
            if not (geometry["stream"] and err <= limit and launched == 1):
                raise AssertionError(
                    f"the streamed forward kernel ({precision}) disagrees "
                    f"with its plain version at H={H}, B={B}: {err} > "
                    f"{limit}, or launched {launched} times")
        # cuDNN's float32 layer in rounds, each between two timings of the
        # port's layer and kernel in the slowest mode this shape runs
        slow = modes[-1]
        prepared = prepare_recurrent_weights(w_hh, slow)
        rounds = {"ms": [], "layer_ms": [], "float32": [],
                  "float32_exact": []}
        for _ in range(WIDE_LIBRARY_ROUNDS):
            rounds["ms"].append(cuda_ms(
                lambda: lstm_bidirectional_recurrence(xw, w_hh, slow,
                                                      prepared),
                runs=5, warmup=1))
            rounds["layer_ms"].append(
                port_layer_ms(projection, w_hh, slow, prepared))
            library = library_lstm_ms(device, T, B, WIDE_D_IN, H,
                                      dtypes=("float32",))
            rounds["float32"].append(library["float32"])
            rounds["float32_exact"].append(library["float32_exact"])
        row["library"] = {k: statistics.median(v) for k, v in
                          rounds.items() if k.startswith("float32")}
        row["rounds"] = dict(rounds, mode=slow)
        faster = sum(k < c for k, c in zip(rounds["ms"], rounds["float32"]))
        log(f"  cuDNN torch.nn.LSTM float32 layer (D_in {WIDE_D_IN}) at "
            f"H={H}, B={B}, {WIDE_LIBRARY_ROUNDS} rounds, ms: "
            f"{fmt_ms(rounds['float32'])} under torch's default flags "
            f"(TF32 allowed), {fmt_ms(rounds['float32_exact'])} with TF32 "
            f"off; between them the port's {slow!r} kernel "
            f"{fmt_ms(rounds['ms'])}, its layer "
            f"{fmt_ms(rounds['layer_ms'])}; the kernel is faster than "
            f"cuDNN's default-flags layer in {faster} of "
            f"{WIDE_LIBRARY_ROUNDS} rounds")
        forward[f"H={H} B={B}"] = row
        del xw, w_hh, projection
        torch.cuda.empty_cache()
    edges = check_wide_edges(device)
    for precision, value in edges["forward_max_abs_err"].items():
        worst[precision] = max(worst[precision], value)

    backward, worst_backward = {}, dict(edges["backward"])
    autograd = {p: {"forward": 0.0, "xw": 0.0, "w_hh": 0.0}
                for p in AUTOGRAD_GRAD_RTOL}
    for T, B, H in WIDE_BACKWARD:
        name = f"streamed H={H}"
        xw, w_hh, _ = layer_inputs(device, T, B, WIDE_D_IN, H, 2, seed=B + H)
        grad = torch.randn(T, B, 2 * H, device=device,
                           generator=torch.Generator(device).manual_seed(H))
        errs = check_backward_kernel(name, T, B, xw, w_hh, grad)
        for key, value in errs.items():
            worst_backward[key] = max(worst_backward[key], value)
        if H == 512:
            hold_recurrence_autograd(name, T, B, xw, w_hh, grad, autograd)
        del xw, w_hh, grad
        torch.cuda.empty_cache()
        row = autograd_timings(device, T, B, WIDE_D_IN, old_backward=False,
                               H=H)
        log_autograd_timings(name, row)
        backward[f"H={H} B={B}"] = dict(row, **errs)
        torch.cuda.empty_cache()
    log(f"the streamed route's checks took {time.perf_counter() - start:.1f}"
        f" s")
    return {"forward": forward, "forward_max_abs_err": worst,
            "backward": backward,
            "backward_grad_rel_l2": max(worst_backward["xw"],
                                        worst_backward["w_hh"]),
            "backward_max_abs_err": worst_backward["max_abs"],
            "autograd": autograd}


def synth_conversation(minutes: float, seed: int, speakers: int):
    """A PCM16-exact waveform and its turns: ``speakers`` harmonic voices
    (the test corpus's recipe) taking turns of 1-6 s with pauses and, a
    third of the time, an overlapping second voice."""
    rng = np.random.default_rng(seed)
    n = int(minutes * 60 * SAMPLE_RATE)
    wav = 0.003 * rng.standard_normal(n)
    turns, t = [], 0.5
    while t < minutes * 60 - 1.0:
        who = int(rng.integers(speakers))
        length = float(rng.uniform(1.0, 6.0))
        turns.append((who, t, min(t + length, minutes * 60 - 0.5)))
        if rng.uniform() < 1 / 3 and speakers > 1:
            other = (who + 1 + int(rng.integers(speakers - 1))) % speakers
            start = t + float(rng.uniform(0.3, 0.8)) * length
            turns.append((other, start, min(start + float(
                rng.uniform(0.5, 2.5)), minutes * 60 - 0.5)))
        t += length + float(rng.uniform(0.2, 1.5))
    turns = [(who, start, end) for who, start, end in turns
             if end - start >= 0.2]
    for who, start, end in turns:
        i0, i1 = int(start * SAMPLE_RATE), int(end * SAMPLE_RATE)
        tt = np.arange(i1 - i0) / SAMPLE_RATE
        voice = sum(np.sin(2 * np.pi * SPEAKER_F0[who] * h * tt
                           + rng.uniform(0, 2 * np.pi)) / h
                    for h in range(1, 6))
        voice *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3.0 * tt))
        wav[i0:i1] += 0.2 * voice + 0.02 * rng.standard_normal(i1 - i0)
    wav = np.round(np.clip(wav, -1, 1) * 32767).astype(np.float32) / 32768.0
    return wav[None], turns


def write_training_protocol(root: Path, seed: int = 0):
    """The synthetic protocol of (x): TRAIN_FILES files of
    TRAIN_FILE_MINUTES with 2-4 speakers and a DEV_MINUTES development
    file, WAVs and annotations written from ``seed``."""
    from pyannote_audio_tpu_torch.core.annotation import (Annotation,
                                                          Timeline)
    from pyannote_audio_tpu_torch.core.io import write_wav
    from pyannote_audio_tpu_torch.core.segment import Segment
    from pyannote_audio_tpu_torch.utils.database import Protocol

    def one(uri, minutes, file_seed, speakers):
        wav, turns = synth_conversation(minutes, file_seed, speakers)
        path = root / f"{uri}.wav"
        write_wav(path, wav, SAMPLE_RATE)
        annotation = Annotation(uri=uri)
        for who, start, end in turns:
            segment = Segment(start, end)
            annotation[segment, annotation.new_track(segment)] = \
                f"{uri}_spk{who}"
        return {"uri": uri, "audio": str(path), "annotation": annotation,
                "annotated": Timeline([Segment(0.0, minutes * 60)],
                                      uri=uri)}
    train = [one(f"train{i}", TRAIN_FILE_MINUTES, seed + i, 2 + i % 3)
             for i in range(TRAIN_FILES)]
    dev = [one("dev0", DEV_MINUTES, seed + 100, 3)]
    return Protocol("Synthetic.SpeakerDiarization.Train",
                    {"train": train, "development": dev})


def training_task(protocol, **kwargs):
    """The reference's SpeakerDiarization training defaults: 10 s chunks,
    3 speakers per chunk, 2 per frame, batches of 32."""
    from pyannote_audio_tpu_torch.tasks import SpeakerDiarization
    options = dict(duration=10.0, max_speakers_per_chunk=3,
                   max_speakers_per_frame=2, batch_size=TRAIN_BATCH,
                   num_workers=2, seed=0)
    options.update(kwargs)
    return SpeakerDiarization(protocol, **options)


def published_pyannet(seed: int = 0):
    """PyanNet at published width (sinc stride 10, BiLSTM 2 x 128, 2 x
    Linear 128, the 7-class powerset of 3 speakers), seeded."""
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    return PyanNet(generator=torch.Generator().manual_seed(seed))


def one_step_grads(model, task, trainer, batch):
    """(loss, {name: gradient}) of one forward and backward."""
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    model.zero_grad(set_to_none=True)
    loss = task.loss(model, trainer.to_device(batch))
    with exact_float32():
        loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}


@contextlib.contextmanager
def plain_lstm():
    """The card's LSTM through the plain recurrence's own autograd (no
    kernel): the card held against itself."""
    from pyannote_audio_tpu_torch.models.blocks import rnn
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain

    class Plain:
        @staticmethod
        def apply(xw, w_hh, precision=None, prepared=None):
            return lstm_bidirectional_recurrence_plain(xw, w_hh, precision)

    saved = rnn.LSTMRecurrence
    rnn.LSTMRecurrence = Plain
    try:
        yield
    finally:
        rnn.LSTMRecurrence = saved


def sincnet_float64_errors(sincnet, X: np.ndarray, device) -> dict:
    """{name: relative L2} of each SincNet gradient, card against CPU,
    with the block in float64 on the chunks ``X`` and one seeded upstream
    gradient (exact path: no bf16)."""
    grads = {}
    for where in ("cpu", device):
        block = copy.deepcopy(sincnet).double().to(where)
        out = block(torch.from_numpy(X.astype(np.float64)).to(where))
        out.backward(torch.randn(out.shape, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(0))
                     .to(where))
        grads[str(where)] = {n: p.grad for n, p in block.named_parameters()}
    cpu = grads["cpu"]
    floor = 1e-6 * float(torch.sqrt(sum(g.square().sum()
                                        for g in cpu.values())))
    return {n: grad_rel_l2(grads[str(device)][n], g, floor)
            for n, g in cpu.items()}


def check_training_step(device, protocol) -> None:
    """(x) one step of full-width PyanNet on 4 ten-second chunks, card
    against CPU on the exact path; then 3 Adam steps each; then the card's
    kernel path against its all-plain path."""
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.train import Trainer
    with exact_path():
        task = training_task(protocol, batch_size=4, num_workers=0)
        cpu_model = published_pyannet(seed=1)
        task.setup(cpu_model)
        attach_specifications(cpu_model, task.specifications)
        card_model = copy.deepcopy(cpu_model).to(device)
        batches = list(itertools.islice(task.train_batches(epoch=0), 3))
        cpu, card = Trainer(device="cpu"), Trainer(device=device)
        reset_lstm()
        t0 = time.perf_counter()
        card_loss, card_grads = one_step_grads(card_model, task, card,
                                               batches[0])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        # one forward and one backward launch per BiLSTM layer
        assert (lstm_launches(), backward_launches()) == (2, 2), \
            (lstm_launches(), backward_launches())
        t0 = time.perf_counter()
        cpu_loss, cpu_grads = one_step_grads(cpu_model, task, cpu, batches[0])
        cpu_s = time.perf_counter() - t0
        nudged = copy.copy(batches[0])
        nudged.X = batches[0].X * np.float32(1 + 2 ** -22)
        _, nudged_grads = one_step_grads(cpu_model, task, cpu, nudged)
        loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
        floor = 1e-6 * float(torch.sqrt(sum(g.double().square().sum()
                                            for g in cpu_grads.values())))
        errs = {n: grad_rel_l2(card_grads[n], cpu_grads[n], floor)
                for n in cpu_grads}
        sinc = {n for n in errs if n.startswith("sincnet.")}
        rest = max(errs[n] for n in errs if n not in sinc)
        moved = max(grad_rel_l2(nudged_grads[n], cpu_grads[n], floor)
                    for n in sinc)
        log(f"(x) one step, 4 x 10 s, exact path: loss card {card_loss:.7f} "
            f"CPU {cpu_loss:.7f} (relative {loss_err:.2e}, limit "
            f"{TRAIN_LOSS_RTOL}); gradient relative L2 outside SincNet "
            f"{rest:.3e} (limit {TRAIN_GRAD_RTOL}), LSTM "
            f"{max(v for k, v in errs.items() if k.startswith('lstm')):.3e}, "
            f"SincNet {max(errs[n] for n in sinc):.3e} at "
            f"{max(sinc, key=errs.get)} (limit {TRAIN_SINC_GRAD_RTOL}; the "
            f"CPU's own SincNet gradients move by {moved:.3e} when the "
            f"waveform moves by 2 ulp); forward + backward card "
            f"{card_s:.2f} s, CPU {cpu_s:.2f} s")
        if not (loss_err <= TRAIN_LOSS_RTOL and rest <= TRAIN_GRAD_RTOL
                and all(errs[n] <= TRAIN_SINC_GRAD_RTOL for n in sinc)):
            raise AssertionError(f"(x) card and CPU gradients part: "
                                 f"{loss_err}, {errs}")
        f64 = sincnet_float64_errors(cpu_model.sincnet, batches[0].X, device)
        log(f"(x) SincNet in float64, card vs CPU: gradient relative L2 "
            f"worst {max(f64.values()):.3e} at {max(f64, key=f64.get)}, "
            f"filter edges {f64['conv1d.0.filterbank.low_hz_']:.3e} / "
            f"{f64['conv1d.0.filterbank.band_hz_']:.3e} (limit "
            f"{SINC_F64_GRAD_RTOL})")
        if max(f64.values()) > SINC_F64_GRAD_RTOL:
            raise AssertionError(f"(x) SincNet's float64 gradients part, "
                                 f"card vs CPU: {f64}")

        # the card's kernel path against its all-plain path: the LSTM's
        # and SincNet's gradients are present, nonzero and the same
        with plain_lstm():
            plain_loss, plain_grads = one_step_grads(card_model, task, card,
                                                     batches[0])
        perrs = {n: grad_rel_l2(card_grads[n], plain_grads[n], floor)
                 for n in plain_grads if n not in sinc}
        for name in ("lstm.weight_hh_l0", "lstm.weight_ih_l0",
                     "lstm.weight_hh_l1_reverse", "sincnet.conv1d.1.weight",
                     "sincnet.conv1d.0.filterbank.low_hz_"):
            if not card_grads[name].abs().max() > 0:
                raise AssertionError(f"(x) no gradient reaches {name}")
        log(f"(x) card kernel path vs all-plain path: loss "
            f"{abs(card_loss - plain_loss):.2e} apart, gradient relative L2 "
            f"worst {max(perrs.values()):.3e}; |grad| of lstm.weight_hh_l0 "
            f"{float(card_grads['lstm.weight_hh_l0'].norm()):.3e}, "
            f"sincnet.conv1d.1.weight "
            f"{float(card_grads['sincnet.conv1d.1.weight'].norm()):.3e}")
        if max(perrs.values()) > TRAIN_GRAD_RTOL:
            raise AssertionError(f"(x) kernel path vs plain path: {perrs}")

        # 3 Adam steps on each side from the same weights
        start = {n: p.detach().cpu().clone()
                 for n, p in cpu_model.named_parameters()}
        results = {}
        for key, trainer, model in (("cpu", cpu, cpu_model),
                                    ("card", card, card_model)):
            params = list(model.parameters())
            optimizer = trainer.make_optimizer(params)
            for batch in batches:
                trainer.train_step(model, task, optimizer, params,
                                   [False] * len(params),
                                   trainer.to_device(batch))
            results[key] = {n: p.detach().cpu()
                            for n, p in model.named_parameters()}
        most = 2 * TRAIN_LR * len(batches)
        worst_abs = max(float((results["card"][n] - results["cpu"][n])
                              .abs().max()) for n in start)
        updates = update_errors(results["card"], results["cpu"], start)
        upd = [torch.cat([(results[k][n] - start[n]).ravel() for n in start])
               for k in ("card", "cpu")]
        update_err = grad_rel_l2(upd[0], upd[1])
        log(f"(x) after {len(batches)} Adam steps (lr {TRAIN_LR}): card vs "
            f"CPU max_abs {worst_abs:.3e} (limit {most}); update relative "
            f"L2 by module, worst tensor {format_worst(updates)} (limit "
            f"{TRAIN_PARAM_UPDATE_RTOL} outside sincnet), the model's "
            f"{update_err:.3e} (limit {TRAIN_UPDATE_RTOL})")
        if worst_abs > most or update_err > TRAIN_UPDATE_RTOL or any(
                v > TRAIN_PARAM_UPDATE_RTOL for k, (_, v) in updates.items()
                if k != "sincnet"):
            raise AssertionError("(x) card and CPU part after 3 Adam steps")


def step_split_ms(model, task, trainer, batch, runs: int = 3) -> dict:
    """Median host milliseconds of a training step's forward + loss,
    backward, and optimizer step with its selections, the card
    synchronised between them (the step is bound by the host's dispatch,
    so its wall is its cost); on a copy of the model."""
    from pyannote_audio_tpu_torch.train.trainer import train_mode
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    model = copy.deepcopy(model)
    train_mode(model)
    names, params = zip(*model.named_parameters())
    optimizer = trainer.make_optimizer(list(params), list(names))
    batch = trainer.to_device(batch)
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss = task.loss(model, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with exact_float32():
            loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, value in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(value * 1e3)
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def check_training_run(device, protocol, workdir: Path) -> dict:
    """(x) Trainer.fit at full width on the card, at its defaults (the
    accelerator gates unset, the LSTM at "default"): 2 epochs of 5
    steps, validation on the development file, checkpoints; then the
    best checkpoint through Model.from_pretrained and resume_from."""
    from pyannote_audio_tpu_torch.core.model import Model
    from pyannote_audio_tpu_torch.train import Trainer
    from pyannote_audio_tpu_torch.train.trainer import TRAIN_STATE
    ckpt = workdir / "training"
    task = training_task(protocol)
    model = published_pyannet(seed=2)
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, limit_train_batches=TRAIN_STEPS,
                      learning_rate=TRAIN_LR, checkpoint_dir=ckpt,
                      device=device)
    reset_lstm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(model, task)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches, fit_backward = lstm_launches(), backward_launches()
    val_chunks = len(task.prepare_validation())
    val_batches = -(-val_chunks // 32)
    expected = TRAIN_EPOCHS * (TRAIN_STEPS * 2 + val_batches * 2)
    reset_lstm()
    t0 = time.perf_counter()
    record = trainer.validate(model, task)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_launches, val_backward = lstm_launches(), backward_launches()
    # the fit's launches less its validations', over its steps
    per_step = (launches - TRAIN_EPOCHS * val_launches) \
        / (TRAIN_EPOCHS * TRAIN_STEPS)
    split = step_split_ms(model, task, trainer,
                          next(task.train_batches(epoch=0)))
    timings = [t for t in trainer.step_timings if t[0] == TRAIN_EPOCHS - 1]
    batch_s = statistics.median(t[1] for t in timings)
    queue_s = statistics.median(t[2] for t in timings)
    card_ms = statistics.median(t[3] for t in timings)
    step_ms = statistics.median((t[1] + t[2]) * 1e3 for t in timings)
    steps_per_s = 1e3 / max(step_ms, card_ms)
    audio_h_per_h = steps_per_s * TRAIN_BATCH * task.duration
    losses = [h["loss"] for h in trainer.history]
    log(f"(x) Trainer.fit: {TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x 10 s in {fit_s:.1f} s; warm step (epoch "
        f"{TRAIN_EPOCHS - 1}, median): host batch wait {batch_s * 1e3:.1f} "
        f"ms + host queueing {queue_s * 1e3:.1f} ms, card {card_ms:.1f} ms; "
        f"{steps_per_s:.3f} steps/s, {audio_h_per_h:.0f} audio-hours seen "
        f"per hour; peak {peak / 2**30:.3f} GiB; loss per epoch {losses}; "
        f"der/val {[h.get('der/val') for h in trainer.history]}; "
        f"validation of {val_chunks} chunks {val_s:.2f} s")
    total = sum(split.values())
    log(f"(x) one step split, card synchronised between the parts: forward + "
        f"loss {split['forward']:.1f} ms, backward {split['backward']:.1f} "
        f"ms ({100 * split['backward'] / total:.1f} %), optimizer "
        f"{split['optimizer']:.1f} ms")
    backward_per_step = fit_backward / (TRAIN_EPOCHS * TRAIN_STEPS)
    log(f"(x) LSTM kernel launches: {launches} in the fit (expected "
        f"{expected}: 2 per step and 2 per validation batch of "
        f"{val_batches}), {val_launches} in one validation, so {per_step} "
        f"per step; backward kernel launches: {fit_backward} in the fit "
        f"(expected {2 * TRAIN_EPOCHS * TRAIN_STEPS}: 2 per step), "
        f"{val_backward} in one validation, so {backward_per_step} per "
        f"step")
    if launches != expected or val_launches != 2 * val_batches \
            or per_step != 2:
        raise AssertionError("(x) LSTM launches are not 2 per forward")
    if fit_backward != 2 * TRAIN_EPOCHS * TRAIN_STEPS or val_backward:
        raise AssertionError("(x) backward kernel launches are not 2 per "
                             "step")
    if not all(np.isfinite(losses)) or not np.isfinite(record["der/val"]):
        raise AssertionError(f"(x) non-finite training loss: {losses}")

    # the best checkpoint against the module it was saved from (its
    # epoch's train_state)
    best = Model.from_pretrained(ckpt / "best").to(device)
    state = torch.load(ckpt / f"epoch_{trainer.best_epoch}" / TRAIN_STATE,
                       map_location=device, weights_only=True)
    trained = copy.deepcopy(model)
    trained.load_state_dict(state["model"])
    x = torch.from_numpy(synth(10 / 60, seed=3)[None, None]).to(device)
    with torch.inference_mode():
        diff = (best(x) - trained(x)).abs().max().item()
    log(f"(x) best checkpoint (epoch {trainer.best_epoch}) through "
        f"Model.from_pretrained vs the trained module: log-probs "
        f"max_abs {diff:.3e} (limit {CHECKPOINT_LOGP_ATOL})")
    if diff > CHECKPOINT_LOGP_ATOL:
        raise AssertionError("(x) the best checkpoint does not reload")

    # resume from epoch 0 against the uninterrupted run
    resumed_model = published_pyannet(seed=2)
    resumed = Trainer(max_epochs=TRAIN_EPOCHS, limit_train_batches=TRAIN_STEPS,
                      learning_rate=TRAIN_LR, device=device,
                      checkpoint_dir=workdir / "training_resumed")
    resumed.fit(resumed_model, training_task(protocol),
                resume_from=ckpt / "epoch_0")
    last = Path(f"epoch_{TRAIN_EPOCHS - 1}") / TRAIN_STATE
    hold_resume(model, resumed_model, losses, resumed.history,
                *(torch.load(path, map_location="cpu", weights_only=True)
                  for path in (ckpt / "epoch_0" / TRAIN_STATE, ckpt / last,
                               workdir / "training_resumed" / last)))
    return {"fit_s": fit_s, "step_ms": step_ms, "card_ms": card_ms,
            "split_ms": split,
            "batch_ms": batch_s * 1e3, "peak_bytes": peak,
            "launches_per_step": per_step,
            "launches_per_validation": val_launches,
            "launches": launches, "backward_launches": fit_backward,
            "backward_launches_per_step": backward_per_step}


def format_worst(worst: dict) -> str:
    return ", ".join(f"{k} {v:.3e} ({n})" for k, (n, v) in worst.items())


def hold_resume(model, resumed_model, losses, history, start, state,
                resumed_state) -> None:
    """(x) the run resumed from epoch 0 against the uninterrupted one:
    parameters and their epoch-1 updates from ``start`` (epoch 0's
    train_state), Adam's step counts and moments (each run's last
    train_state) and the epoch-1 loss, within the RESUME_* bounds."""
    names = [n for n, _ in model.named_parameters()]
    ours = {n: p.detach().cpu() for n, p in resumed_model.named_parameters()}
    theirs = {n: p.detach().cpu() for n, p in model.named_parameters()}
    most = 2 * TRAIN_LR * TRAIN_STEPS * (TRAIN_EPOCHS - 1)
    worst_abs = max(float((ours[n] - theirs[n]).abs().max()) for n in names)
    updates = update_errors(ours, theirs,
                            {n: start["model"][n] for n in names})
    adam, resumed_adam = (s["optimizer"]["state"]
                          for s in (state, resumed_state))
    steps_equal = set(adam) == set(resumed_adam) and all(
        float(adam[i]["step"]) == float(resumed_adam[i]["step"])
        for i in adam)
    moments = {key: grad_rel_l2(
        torch.cat([resumed_adam[i][key].ravel() for i in range(len(names))]),
        torch.cat([adam[i][key].ravel() for i in range(len(names))]))
        for key in RESUME_MOMENT_RTOL}
    loss_err = abs(history[0]["loss"] - losses[1]) / abs(losses[1])
    log(f"(x) resume_from epoch_0 vs uninterrupted: epochs run "
        f"{[h['epoch'] for h in history]}; Adam step counts equal "
        f"{steps_equal}; max_abs {worst_abs:.3e} (limit {most}: 2 * lr per "
        f"step since the resume); epoch-1 update relative L2 by module, "
        f"worst tensor {format_worst(updates)} (limit {RESUME_UPDATE_RTOL} "
        f"outside sincnet); Adam moments relative L2 "
        + ", ".join(f"{k} {v:.3e} (limit {RESUME_MOMENT_RTOL[k]})"
                    for k, v in moments.items())
        + f"; epoch-1 loss {history[0]['loss']} vs {losses[1]} (relative "
        f"{loss_err:.2e}, limit {RESUME_LOSS_RTOL})")
    if not ([h["epoch"] for h in history] == [1] and steps_equal
            and worst_abs <= most
            and all(v <= RESUME_UPDATE_RTOL for k, (_, v) in updates.items()
                    if k != "sincnet")
            and all(v <= RESUME_MOMENT_RTOL[k] for k, v in moments.items())
            and loss_err <= RESUME_LOSS_RTOL):
        raise AssertionError("(x) resume_from parts from the uninterrupted "
                             "run")


@contextlib.contextmanager
def plain_on_card():
    """Count the plain recurrence's forward and backward calls on CUDA
    tensors (yields the count, a list of one int): the kernels' wrappers
    and the LSTM module reach the plain versions only through these
    names."""
    from pyannote_audio_tpu_torch.ops import lstm, lstm_kernel
    names = ("lstm_bidirectional_recurrence_plain",
             "lstm_bidirectional_recurrence_backward_plain")
    calls = [0]
    saved = {(m, n): getattr(m, n) for m in (lstm, lstm_kernel)
             for n in names}

    def counted(fn):
        def wrapper(xw, *args, **kwargs):
            calls[0] += xw.device.type == "cuda"
            return fn(xw, *args, **kwargs)
        return wrapper

    for (module, name), fn in saved.items():
        setattr(module, name, counted(fn))
    try:
        yield calls
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def check_wide_training_step(device, protocol) -> dict:
    """One training step of a PyanNet with a BiLSTM of H = 512 (the
    streamed route; other widths published) at 32 x 10 s on the card, the
    exact path: one forward and one backward kernel launch per layer, no
    plain recurrence on a CUDA tensor, a finite loss and gradients that
    reach both LSTM layers; then the step's time split (median of 3)."""
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.train import Trainer
    with exact_path():
        task = training_task(protocol, num_workers=0)
        model = PyanNet(lstm_hidden=WIDE_PIPELINE_HIDDEN,
                        generator=torch.Generator().manual_seed(1))
        task.setup(model)
        attach_specifications(model, task.specifications)
        model.to(device)
        trainer = Trainer(device=device)
        batch = next(iter(task.train_batches(epoch=0)))
        with plain_on_card() as plain:
            reset_lstm()
            loss, grads = one_step_grads(model, task, trainer, batch)
            torch.cuda.synchronize()
            launches = (lstm_launches(), backward_launches())
        split = step_split_ms(model, task, trainer, batch)
        reach = {n: float(grads[n].norm()) for n in (
            "lstm.weight_hh_l0", "lstm.weight_hh_l1_reverse",
            "lstm.weight_ih_l0")}
        log(f"(x) at H = {WIDE_PIPELINE_HIDDEN}, one step of "
            f"{len(batch.X)} x 10 s: loss {loss:.6f}, launches (forward, "
            f"backward) {launches}, plain recurrence calls on the card "
            f"{plain[0]}, |grad| {reach}; step split forward + loss "
            f"{split['forward']:.1f} ms, backward {split['backward']:.1f} "
            f"ms, optimizer {split['optimizer']:.1f} ms")
        if not (launches == (2, 2) and plain[0] == 0 and np.isfinite(loss)
                and all(torch.isfinite(g).all() for g in grads.values())
                and all(v > 0 for v in reach.values())):
            raise AssertionError(f"(x) at H = {WIDE_PIPELINE_HIDDEN}: "
                                 f"launches {launches}, plain calls "
                                 f"{plain[0]}, loss {loss}, {reach}")
    return {"launches": launches[0], "backward_launches": launches[1],
            "loss": loss, "split_ms": split}


# the segmentation evaluate on (x)'s development file: the card's aggregate
# DER within EVALUATE_DER_ATOL of the CPU's where both binarize every frame
# alike, else every frame binarized otherwise a near tie (within
# NEAR_THRESHOLD of the onset on the CPU, the rule of (m))
EVALUATE_DER_ATOL = 1e-6


def check_evaluate(device, protocol) -> dict:
    """``tasks.segmentation.evaluate`` (frame-level DER with
    ``DiscreteDiarizationErrorRate``) of full-width PyanNet trained for
    voice activity detection (its head calibrated on 8 chunks of the
    development file so that its scores move with the audio; a random one
    sits at 0.5, a tie everywhere) on the development subset of (x)'s
    protocol, card against CPU on the exact path, with the forward kernel's
    launches counted. Like the JAX package's, ``evaluate`` binarizes
    aggregated frame scores, which a permutation-invariant (diarization)
    model does not give."""
    from pyannote_audio_tpu_torch.core import inference as inference_module
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.tasks import VoiceActivityDetection
    from pyannote_audio_tpu_torch.tasks.segmentation import evaluate
    with exact_path():
        task = VoiceActivityDetection(protocol, duration=10.0,
                                      batch_size=TRAIN_BATCH, num_workers=0)
        cpu_model = published_pyannet(seed=1)
        task.setup(cpu_model)
        attach_specifications(cpu_model, task.specifications)
        # the development file's audio, as write_training_protocol made it
        wav, _ = synth_conversation(DEV_MINUTES, 100, 3)
        chunks = torch.from_numpy(np.stack([
            wav[:, i * SAMPLE_RATE:(i + 10) * SAMPLE_RATE]
            for i in range(0, 80, 10)]).astype(np.float32))
        with torch.inference_mode():
            logit = torch.logit(cpu_model(chunks).double().flatten())
        gain = SEP_LOGIT_SPREAD / logit.std()
        with torch.no_grad():
            head = cpu_model.classifier
            head.weight.mul_(gain.float())
            head.bias.sub_(logit.median().float()).mul_(gain.float())
        card_model = copy.deepcopy(cpu_model)
        ders, scores, launches, seconds = {}, {}, {}, {}
        call = inference_module.Inference.__call__
        for key, model, device_ in (("card", card_model, device),
                                    ("cpu", cpu_model, "cpu")):
            seen = []

            def recorded(self, *args, seen=seen, **kwargs):
                out = call(self, *args, **kwargs)
                seen.append(np.asarray(out.data.cpu() if isinstance(
                    out.data, torch.Tensor) else out.data))
                return out

            inference_module.Inference.__call__ = recorded
            try:
                reset_lstm()
                start = time.perf_counter()
                ders[key] = evaluate(protocol, subset="development",
                                     model=model, display=False,
                                     device=device_)
                seconds[key] = time.perf_counter() - start
            finally:
                inference_module.Inference.__call__ = call
            launches[key] = lstm_launches()
            scores[key] = np.concatenate(seen)
    chunk_count = len(segmentation_batches((DEV_MINUTES,), batch=1))
    expected = 2 * -(-chunk_count // 32)
    differ = binarized_frames("evaluate card vs CPU", scores["card"],
                              scores["cpu"], 0.5)
    gap = abs(ders["card"] - ders["cpu"])
    log(f"evaluate on {DEV_MINUTES:g} min (head gain {float(gain):.3f}): "
        f"DER card {ders['card']:.9f} ({seconds['card']:.2f} s), CPU "
        f"{ders['cpu']:.9f} ({seconds['cpu']:.2f} s), {gap:.3e} apart "
        f"(limit {EVALUATE_DER_ATOL} where no frame binarizes otherwise: "
        f"{int(differ.sum())} do); forward kernel launches on the card "
        f"{launches['card']} (expected {expected}: 2 layers x batches of 32 "
        f"over {chunk_count} chunks), on the CPU {launches['cpu']}")
    if not (np.isfinite(ders["card"]) and 0.0 < ders["cpu"]
            and launches["card"] == expected and launches["cpu"] == 0
            and (differ.any() or gap <= EVALUATE_DER_ATOL)):
        raise AssertionError(f"evaluate: the card's DER {ders['card']} and "
                             f"the CPU's {ders['cpu']} part, or launches "
                             f"{launches}")
    return {"der": ders["card"], "der_cpu": ders["cpu"],
            "launches": launches["card"], "frames_differ": int(differ.sum())}


def phase_training(device, workdir: Path, card: str, protocol) -> dict:
    """Phase 11: training (x) on the card."""
    log(f"phase 11, training, on {card}")
    check_training_step(device, protocol)
    record = check_training_run(device, protocol, workdir)
    record["wide_step"] = check_wide_training_step(device, protocol)
    record["evaluate"] = check_evaluate(device, protocol)
    return record


# -- phase 12: training speaker embeddings (y) and PixIT (z) ----------------

# (y) ArcFace at its defaults (2-5 s chunks on a 0.25 s grid, 8 speakers x
# 4 chunks, margin 28.6, scale 64, Adam 1e-3) on the speakers of (x)'s
# protocol, with WeSpeaker ResNet34 at published width. One step card
# against CPU on the exact path (float32 trunk, TF32 off): the loss within
# TRAIN_LOSS_RTOL, every gradient (the prototypes' included) within
# TRAIN_GRAD_RTOL relative L2 against the larger of its own norm and 1e-6
# of the whole gradient's, as (x) outside SincNet, except BatchNorm's
# affine gradients and the stem's and first stage's conv weights: each is
# a sum over a whole batch of the largest feature maps (up to 1.2e6 terms
# per channel) that cancels, and the first card runs measured up to
# 3.7e-3 (BatchNorm) and 7.5e-4 (a first-stage conv) between card and CPU
# in float32. They are held within ARC_BN_GRAD_RTOL in float32, and the
# cause is settled in float64: the
# trunk, pooling, seg_1 and the loss from the same fbank on ARC_F64_CHUNKS
# chunks, card against CPU, every gradient within SINC_F64_GRAD_RTOL.
# BatchNorm's running statistics unchanged by a step on both. Then Trainer.fit at the model's
# defaults (bf16 trunk): ARC_EPOCHS x ARC_STEPS, the best checkpoint
# through Model.from_pretrained and PretrainedSpeakerEmbedding within
# ARC_EMBEDDING_ATOL of the trained module (the same network on the same
# card), then speaker_verification.main on seeded trials
ARC_BN_GRAD_RTOL = 1e-2
ARC_F64_CHUNKS = 8
ARC_EPOCHS, ARC_STEPS = 2, 5
ARC_EMBEDDING_ATOL = 1e-6
ARC_TRIAL_SPEAKERS, ARC_TRIAL_FILES, ARC_TRIAL_SECONDS = 4, 3, 3.0
# (z) PixIT at its defaults (5 s chunks, 3 speakers per chunk, separation
# weight 0.5, pixit_optimizer(1e-3, 1e-5, 5.0)) with ToTaToNet at its
# defaults and the WAVLM_LARGE branch trained (not frozen). PIXIT_BATCH is
# the training batch (see PERF.md for why it is not 32). One step on 2
# chunks card against CPU with the LSTM at "highest": loss within
# TRAIN_LOSS_RTOL, gradients within TRAIN_GRAD_RTOL relative L2 as (y).
# Batches of 32 do not fit: the first card run's step at 16 peaked at
# 56.7 GiB and one at 32 ran out of the card's 80 GB at 76.5 GiB.
# After one Adam step each group's median move over the elements with a
# gradient lies within PIXIT_MOVE_RTOL of its learning rate (Adam's first
# step moves an element by lr * g / (|g| + eps)). Then Trainer.fit,
# PIXIT_EPOCHS x PIXIT_STEPS with validation on (x)'s development file;
# LSTM launches exact: a forward launches 2 per DPRNN repeat (intra- and
# inter-chunk), 12 at the defaults; a step runs two (the chunks' and the
# MoMs'), so 24, and a validation two per batch of at most 32 (the eval
# forward and the within-batch MoM's)
PIXIT_BATCH = 16
PIXIT_CPU_CHUNKS = 2
# the one step card vs CPU runs WavLM-large at its published widths and 6
# of its 24 layers (the CPU's side of a step takes about 90 s at 24); the
# fit runs all 24
PIXIT_STEP_WAVLM_LAYERS = 6
PIXIT_EPOCHS, PIXIT_STEPS = 1, 3
PIXIT_LR, PIXIT_WAVLM_LR, PIXIT_CLIP = 1e-3, 1e-5, 5.0
PIXIT_MOVE_RTOL = 0.1
PIXIT_MIN_MOM_SHARE = 0.5


def grads_of(model, task, params, batch):
    """(loss, {name: gradient}) of one forward and backward of ``task``'s
    loss on a device batch, with BatchNorm in its training mode; ``params``
    are the named parameters to read (the task's included)."""
    from pyannote_audio_tpu_torch.train.trainer import train_mode
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    train_mode(model)
    for _, p in params:
        p.grad = None
    loss = task.loss(model, batch)
    with exact_float32():
        loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in params if p.grad is not None}


def hold_gradients(label: str, card, cpu, extra: str = "",
                   loose=frozenset(), loose_limit: float = None) -> dict:
    """Card against CPU: (loss, grads) pairs within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_RTOL (the gradients named in ``loose`` within
    ``loose_limit``); returns the errors."""
    (card_loss, card_grads), (cpu_loss, cpu_grads) = card, cpu
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    floor = 1e-6 * float(torch.sqrt(sum(g.double().square().sum()
                                        for g in cpu_grads.values())))
    errs = {n: grad_rel_l2(card_grads[n], cpu_grads[n], floor)
            for n in cpu_grads}
    rest = [n for n in errs if n not in loose]
    worst = max(rest, key=errs.get)
    extra = (f"; {len(loose)} BatchNorm affine and first-stage gradients worst "
             f"{max(errs[n] for n in loose):.3e} at "
             f"{max(loose, key=errs.get)} (limit {loose_limit})"
             if loose else "") + extra
    log(f"{label}: loss card {card_loss:.7f} CPU {cpu_loss:.7f} (relative "
        f"{loss_err:.2e}, limit {TRAIN_LOSS_RTOL}); gradient relative L2 "
        f"worst {errs[worst]:.3e} at {worst} (limit {TRAIN_GRAD_RTOL}) over "
        f"{len(rest)} tensors{extra}")
    if set(card_grads) != set(cpu_grads) or not (
            loss_err <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_RTOL
            and all(errs[n] <= loose_limit for n in loose)):
        raise AssertionError(f"{label}: card and CPU part: {loss_err}, "
                             f"{sorted(errs.items(), key=lambda kv: -kv[1])[:5]}")
    return errs


def task_params(task, model, device, seed: int) -> list:
    """The task's trainable state (ArcFace's prototypes) from a seed, on
    ``device``, set as ``task.trainable_params``; its named pairs."""
    generator = torch.Generator().manual_seed(seed)
    task.trainable_params = {
        name: torch.nn.Parameter(p.to(device))
        for name, p in task.augment_params(model, generator).items()}
    return [(f"task.{n}", p) for n, p in task.trainable_params.items()]


def warm_step_report(label: str, trainer, epochs: int, batch: int,
                     seconds: float) -> dict:
    """Median warm step (the last epoch's) from ``trainer.step_timings``:
    host batch wait, host queueing, card ms; steps/s and audio-hours seen
    per hour."""
    # the fit's first step (cold plans) is left out of a one-epoch fit
    timings = [t for t in trainer.step_timings[1:] if t[0] == epochs - 1]
    batch_ms = statistics.median(t[1] for t in timings) * 1e3
    queue_ms = statistics.median(t[2] for t in timings) * 1e3
    card_ms = statistics.median(t[3] for t in timings)
    steps_per_s = 1e3 / max(batch_ms + queue_ms, card_ms)
    log(f"{label} warm step (epoch {epochs - 1} without the fit's first "
        f"step, median of {len(timings)}): host batch wait "
        f"{batch_ms:.1f} ms + host queueing {queue_ms:.1f} ms, card "
        f"{card_ms:.1f} ms; {steps_per_s:.3f} steps/s, "
        f"{steps_per_s * batch * seconds:.0f} audio-hours seen per hour")
    return {"batch_ms": batch_ms, "queue_ms": queue_ms, "card_ms": card_ms,
            "steps_per_s": steps_per_s}


def log_split(label: str, split: dict) -> None:
    total = sum(split.values())
    log(f"{label} one step split, card synchronised between the parts: "
        f"forward + loss {split['forward']:.1f} ms, backward "
        f"{split['backward']:.1f} ms ({100 * split['backward'] / total:.1f} "
        f"%), optimizer {split['optimizer']:.1f} ms")


def arcface_task(protocol, **kwargs):
    from pyannote_audio_tpu_torch.tasks import \
        SupervisedRepresentationLearningWithArcFace
    options = dict(num_workers=2, seed=0)
    options.update(kwargs)
    return SupervisedRepresentationLearningWithArcFace(protocol, **options)


def published_resnet34(seed: int, **kwargs):
    from pyannote_audio_tpu_torch.models.embedding import WeSpeakerResNet34
    return WeSpeakerResNet34(generator=torch.Generator().manual_seed(seed),
                             **kwargs)


def running_stats(model) -> dict:
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if "running_" in n}


def check_arcface_step(device, protocol) -> None:
    """(y) one ArcFace step of full-width ResNet34, card against CPU on
    the exact path; BatchNorm's running statistics unchanged by an Adam
    step on both."""
    from pyannote_audio_tpu_torch.train import Trainer
    task = arcface_task(protocol, num_workers=0)
    cpu_model = published_resnet34(seed=70, compute_dtype=torch.float32)
    task.setup(cpu_model)
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = next(task.train_batches(epoch=0))
    log(f"(y) ArcFace on {len(task.classes)} speakers; batch of "
        f"{batch.X.shape[0]} x {batch.X.shape[-1] / SAMPLE_RATE:g} s, "
        f"{len(set(batch.y.tolist()))} speakers")
    results, stats = {}, running_stats(cpu_model)
    for where, model in (("card", card_model), ("cpu", cpu_model)):
        trainer = Trainer(device=where if where == "cpu" else device)
        params = list(model.named_parameters()) + task_params(
            task, model, trainer.device, seed=71)
        reset_lstm()
        t0 = time.perf_counter()
        results[where] = grads_of(model, task, params,
                                  trainer.to_device(batch))
        if where == "card":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        optimizer = trainer.make_optimizer([p for _, p in params])
        trainer.train_step(model, task, optimizer, [p for _, p in params],
                           [False] * len(params), trainer.to_device(batch))
        moved = [n for n, b in running_stats(model).items()
                 if not torch.equal(b, stats[n])]
        log(f"(y) {where}: forward + backward {seconds:.2f} s; running "
            f"statistics moved by an Adam step: {len(moved)} of {len(stats)}")
        if moved or lstm_launches():
            raise AssertionError(f"(y) {where}: BatchNorm running statistics "
                                 f"moved ({moved[:3]}) or the LSTM ran")
    norms = {f"{name}.{kind}" for name, module in cpu_model.named_modules()
             if isinstance(module, torch.nn.BatchNorm2d)
             for kind in ("weight", "bias")}
    first = {n for n, _ in cpu_model.named_parameters()
             if n.startswith(("resnet.conv1.", "resnet.layer1."))}
    loose = norms | first
    hold_gradients("(y) one ArcFace step, exact path", results["card"],
                   results["cpu"], loose=loose, loose_limit=ARC_BN_GRAD_RTOL)
    f64 = arcface_float64_errors(cpu_model, task, batch, device)
    worst = max(f64, key=f64.get)
    log(f"(y) float64 witness (trunk, pooling, seg_1 and the loss from the "
        f"same fbank, {ARC_F64_CHUNKS} chunks), card vs CPU: gradient "
        f"relative L2 worst {f64[worst]:.3e} at {worst}, BatchNorm affine "
        f"and first stage worst {max(f64[n] for n in loose):.3e} (limit "
        f"{SINC_F64_GRAD_RTOL})")
    if f64[worst] > SINC_F64_GRAD_RTOL:
        raise AssertionError(f"(y) float64 gradients part, card vs CPU: "
                             f"{worst} {f64[worst]}")


def arcface_float64_errors(model, task, batch, device) -> dict:
    """{name: relative L2} of each gradient of the ArcFace loss, card
    against CPU, with ``model`` (its trunk, pooling and seg_1) and the
    prototypes in float64, from the float32 fbank of the first
    ARC_F64_CHUNKS chunks (the fbank has no parameters)."""
    from pyannote_audio_tpu_torch.ops.fbank import wespeaker_fbank
    from pyannote_audio_tpu_torch.tasks.embedding import arcface_loss
    from pyannote_audio_tpu_torch.train.trainer import train_mode
    X = torch.from_numpy(batch.X[:ARC_F64_CHUNKS])
    with torch.no_grad():
        feats = wespeaker_fbank(X).double()
    labels = torch.from_numpy(batch.y[:ARC_F64_CHUNKS]).long()
    prototypes = task.augment_params(
        model, torch.Generator().manual_seed(71))["arcface"].double()
    grads = {}
    for where in ("cpu", device):
        block = copy.deepcopy(model).double().to(where)
        train_mode(block)
        protos = prototypes.to(where).clone().requires_grad_()
        # frames_from_fbank's steps, without its cast to float32
        x = block.resnet.trunk(feats.to(where).transpose(1, 2)[:, None])
        B, C, Fr, T = x.shape
        frames = x.reshape(B, C * Fr, T).transpose(1, 2)
        loss = arcface_loss(block.embed(frames), labels.to(where), protos,
                            margin_deg=task.margin, scale=task.scale)
        loss.backward()
        grads[str(where)] = {**{n: p.grad for n, p in
                                block.named_parameters()},
                             "task.arcface": protos.grad}
    cpu = grads["cpu"]
    floor = 1e-6 * float(torch.sqrt(sum(g.square().sum()
                                        for g in cpu.values())))
    return {n: grad_rel_l2(grads[str(device)][n], g, floor)
            for n, g in cpu.items()}


def write_trial_files(root: Path) -> list:
    """ARC_TRIAL_SPEAKERS harmonic voices (SPEAKER_F0's recipe) in
    ARC_TRIAL_FILES seeded files each; every pair is a trial, the same
    voice a target one."""
    from pyannote_audio_tpu_torch.core.io import write_wav
    files = []
    n = int(ARC_TRIAL_SECONDS * SAMPLE_RATE)
    tt = np.arange(n) / SAMPLE_RATE
    for who in range(ARC_TRIAL_SPEAKERS):
        for k in range(ARC_TRIAL_FILES):
            rng = np.random.default_rng(1000 + 10 * who + k)
            voice = sum(np.sin(2 * np.pi * SPEAKER_F0[who] * h * tt
                               + rng.uniform(0, 2 * np.pi)) / h
                        for h in range(1, 6))
            voice *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3.0 * tt))
            wav = 0.2 * voice + 0.02 * rng.standard_normal(n)
            path = root / f"trial_{who}_{k}.wav"
            write_wav(path, wav[None].astype(np.float32), SAMPLE_RATE)
            files.append(({"uri": path.stem, "audio": str(path)}, who))
    return [{"file1": a, "file2": b, "reference": int(wa == wb)}
            for (a, wa), (b, wb) in itertools.combinations(files, 2)]


def check_arcface_run(device, protocol, workdir: Path) -> dict:
    """(y) Trainer.fit at the model's defaults, the best checkpoint
    through Model.from_pretrained and PretrainedSpeakerEmbedding, and
    speaker_verification.main on seeded trials."""
    from pyannote_audio_tpu_torch.core.model import Model
    from pyannote_audio_tpu_torch.pipelines.speaker_verification import (
        PretrainedSpeakerEmbedding, main as verification_main)
    from pyannote_audio_tpu_torch.train import Trainer
    from pyannote_audio_tpu_torch.train.trainer import TRAIN_STATE
    from pyannote_audio_tpu_torch.utils.database import Protocol
    ckpt = workdir / "arcface"
    task = arcface_task(protocol)
    model = published_resnet34(seed=72)
    trainer = Trainer(max_epochs=ARC_EPOCHS, limit_train_batches=ARC_STEPS,
                      learning_rate=TRAIN_LR, checkpoint_dir=ckpt,
                      device=device)
    stats = running_stats(model)
    reset_lstm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(model, task)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = lstm_launches() + backward_launches()
    losses = [h["loss"] for h in trainer.history]
    moved = [n for n, b in running_stats(model).items()
             if not torch.equal(b, stats[n])]
    log(f"(y) Trainer.fit: {ARC_EPOCHS} epochs x {ARC_STEPS} steps of "
        f"{task.batch_size} x 2-5 s in {fit_s:.1f} s; peak "
        f"{peak / 2**30:.3f} GiB; loss per epoch {losses}; LSTM launches, "
        f"forward and backward, {launches} (expected 0); running statistics "
        f"moved: {len(moved)}")
    warm = warm_step_report("(y)", trainer, ARC_EPOCHS, task.batch_size,
                            (task.min_duration + task.duration) / 2)
    # the fit's batches drawn again (same seeds): card ms of each step by
    # whether its chunk duration came before
    shapes = []
    for epoch in range(ARC_EPOCHS):
        batches = task.train_batches_parallel(epoch=epoch)
        shapes += [b.X.shape[-1] for b in
                   itertools.islice(batches, ARC_STEPS)]
        batches.close()
    seen, by_shape = set(), {"new": [], "seen": []}
    for shape, timing in zip(shapes, trainer.step_timings):
        by_shape["seen" if shape in seen else "new"].append(timing[3])
        seen.add(shape)
    log(f"(y) card ms per step by chunk duration: "
        + "; ".join(f"{key} {statistics.median(v):.1f} ms over {len(v)} "
                    f"steps" for key, v in by_shape.items() if v)
        + f" ({len(seen)} durations in {len(shapes)} steps)")
    split = step_split_ms(model, task, trainer,
                          next(task.train_batches(epoch=0)))
    log_split("(y)", split)
    if launches or moved or not all(np.isfinite(losses)):
        raise AssertionError("(y) the fit launched the LSTM, moved running "
                             f"statistics or diverged: {losses}")

    # the best checkpoint through both loaders, against its epoch's module
    state = torch.load(ckpt / f"epoch_{trainer.best_epoch}" / TRAIN_STATE,
                       map_location=device, weights_only=True)
    trained = copy.deepcopy(model)
    trained.load_state_dict(state["model"])
    trained.eval()
    x = chunk_batch(1.0, 5.0, 8, seed=73)
    with torch.inference_mode():
        ours = trained(torch.from_numpy(x).to(device)).float().cpu().numpy()
        reloaded = Model.from_pretrained(ckpt / "best").to(device)
        via_model = reloaded(torch.from_numpy(x).to(device)).float().cpu()
    via_wrapper = PretrainedSpeakerEmbedding(ckpt / "best", device=device)(x)
    diffs = (float(np.abs(via_model.numpy() - ours).max()),
             float(np.abs(via_wrapper - ours).max()))
    log(f"(y) best checkpoint (epoch {trainer.best_epoch}) vs the trained "
        f"module on 8 x 5 s: Model.from_pretrained max_abs {diffs[0]:.3e}, "
        f"PretrainedSpeakerEmbedding {diffs[1]:.3e} (limit "
        f"{ARC_EMBEDDING_ATOL})")
    if max(diffs) > ARC_EMBEDDING_ATOL:
        raise AssertionError("(y) the best checkpoint does not reload")

    class Trials(Protocol):
        def test_trial(self):
            return iter(trials)

    trials = write_trial_files(workdir)
    t0 = time.perf_counter()
    eer = verification_main(Trials("Synthetic.SpeakerVerification.Trials"),
                            subset="test", embedding=ckpt / "best",
                            device=device)
    log(f"(y) speaker_verification.main on {len(trials)} seeded trials of "
        f"{ARC_TRIAL_SPEAKERS} voices: EER {eer:.4f} in "
        f"{time.perf_counter() - t0:.2f} s")
    if not np.isfinite(eer):
        raise AssertionError("(y) no EER")
    return {"fit_s": fit_s, "peak_bytes": peak, "split_ms": split,
            "launches": launches, "eer": eer, **warm}


def lstm_launches_per_forward(model) -> int:
    """ToTaToNet's LSTM launches per forward: the DPRNN's intra- and
    inter-chunk BiLSTM in each repeat."""
    return 2 * model.dprnn["n_repeats"]


def pixit_task(protocol, **kwargs):
    from pyannote_audio_tpu_torch.tasks import PixIT
    options = dict(batch_size=PIXIT_BATCH, num_workers=2, seed=0)
    options.update(kwargs)
    return PixIT(protocol, **options)


def pixit_trainer(device, **kwargs):
    from pyannote_audio_tpu_torch.tasks.separation import pixit_optimizer
    from pyannote_audio_tpu_torch.train import Trainer
    return Trainer(device=device, optimizer=pixit_optimizer(
        PIXIT_LR, PIXIT_WAVLM_LR, PIXIT_CLIP), **kwargs)


def check_pixit_step(device, protocol) -> None:
    """(z) one PixIT step of ToTaToNet + WavLM-large (its widths,
    PIXIT_STEP_WAVLM_LAYERS layers) on PIXIT_CPU_CHUNKS chunks, card against
    CPU with the LSTM at "highest"; the card's
    kernel path against its all-plain path; one pixit_optimizer step's
    moves per group."""
    task = pixit_task(protocol, batch_size=PIXIT_CPU_CHUNKS, num_workers=0)
    cpu_model = make_totatonet("cpu", wavlm_layers=PIXIT_STEP_WAVLM_LAYERS)
    task.setup(cpu_model)
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = next(task.train_batches(epoch=0))
    log(f"(z) PixIT step on {len(batch.X)} x 5 s, MoM weights "
        f"{batch.meta['mom_weight'].tolist()}")
    results, seconds = {}, {}
    with lstm_precision_env("highest"):
        for where, model in (("card", card_model), ("cpu", cpu_model)):
            trainer = pixit_trainer(where if where == "cpu" else device)
            reset_lstm()
            t0 = time.perf_counter()
            results[where] = grads_of(model, task,
                                      list(model.named_parameters()),
                                      trainer.to_device(batch))
            if where == "card":
                torch.cuda.synchronize()
                card_launches = (lstm_launches(), backward_launches())
            seconds[where] = time.perf_counter() - t0
        per_step = 2 * lstm_launches_per_forward(card_model)
        hold_gradients(f"(z) one PixIT step (WavLM-large at "
                       f"{PIXIT_STEP_WAVLM_LAYERS} of its 24 layers), LSTM at "
                       f"highest",
                       results["card"], results["cpu"],
                       f"; forward + backward card {seconds['card']:.2f} s "
                       f"({card_launches} LSTM forward and backward "
                       f"launches), CPU {seconds['cpu']:.2f} s")
        if card_launches != (per_step, per_step):
            raise AssertionError(f"(z) {card_launches} LSTM launches in a "
                                 f"step, not {per_step} of each")
        with plain_lstm():
            plain = grads_of(card_model, task,
                             list(card_model.named_parameters()),
                             pixit_trainer(device).to_device(batch))
    card_loss, card_grads = results["card"]
    floor = 1e-6 * float(torch.sqrt(sum(g.double().square().sum()
                                        for g in card_grads.values())))
    perr = max(grad_rel_l2(card_grads[n], plain[1][n], floor)
               for n in card_grads)
    lstm_norm = float(card_grads["masker.net.0.intra_RNN.rnn.weight_hh_l0"]
                      .norm())
    log(f"(z) card kernel path vs all-plain path (highest): loss "
        f"{abs(card_loss - plain[0]):.2e} apart, gradient relative L2 worst "
        f"{perr:.3e}; |grad| of the first intra-chunk W_hh {lstm_norm:.3e}")
    if perr > TRAIN_GRAD_RTOL or not lstm_norm > 0:
        raise AssertionError(f"(z) kernel path vs plain path: {perr}")

    # one pixit_optimizer step: each group moves by about its rate
    trainer = pixit_trainer(device)
    names, params = zip(*card_model.named_parameters())
    start = [p.detach().clone() for p in params]
    optimizer = trainer.make_optimizer(list(params), list(names))
    trainer.train_step(card_model, task, optimizer, list(params),
                       [False] * len(params), trainer.to_device(batch))
    moves = {"wavlm": [], "rest": []}
    for name, p, before in zip(names, params, start):
        grad = card_grads[name]
        step = (p.detach() - before).abs()[grad != 0]
        moves["wavlm" if "wavlm" in name.split(".") else "rest"].append(step)
    medians = {k: float(torch.cat(v).median()) for k, v in moves.items()}
    log(f"(z) one pixit_optimizer step: median move of the elements with a "
        f"gradient, WavLM {medians['wavlm']:.3e} (lr {PIXIT_WAVLM_LR}), the "
        f"rest {medians['rest']:.3e} (lr {PIXIT_LR}); limit "
        f"{PIXIT_MOVE_RTOL} relative")
    for key, lr in (("wavlm", PIXIT_WAVLM_LR), ("rest", PIXIT_LR)):
        if abs(medians[key] - lr) > PIXIT_MOVE_RTOL * lr:
            raise AssertionError(f"(z) the {key} group moved by "
                                 f"{medians[key]}, not about {lr}")


def check_pixit_run(device, protocol) -> dict:
    """(z) Trainer.fit under PixIT at full width with validation: LSTM
    launches per step and per validation, warm step, split, peak."""
    task = pixit_task(protocol)
    model = make_totatonet(device)
    task.setup(model)
    shares = [float(b.meta["mom_weight"].mean()) for b in
              itertools.islice(task.train_batches(epoch=0), PIXIT_STEPS)]
    val_chunks = len(task.prepare_validation())
    val_batches = -(-val_chunks // 32)
    per_step = 2 * lstm_launches_per_forward(model)
    per_validation = per_step * val_batches
    expected = PIXIT_EPOCHS * (per_step * PIXIT_STEPS + per_validation)
    log(f"(z) PixIT batches of {PIXIT_BATCH} x 5 s: share of items with a "
        f"drawn MoM {shares} (limit > {PIXIT_MIN_MOM_SHARE}); LSTM launches "
        f"expected: {per_step} per step, {per_validation} per validation of "
        f"{val_chunks} chunks ({val_batches} batches of at most 32 x "
        f"{per_step}), {expected} in the fit")
    if min(shares) <= PIXIT_MIN_MOM_SHARE:
        raise AssertionError("(z) too few drawn MoMs: MixIT not exercised")
    trainer = pixit_trainer(device, max_epochs=PIXIT_EPOCHS,
                            limit_train_batches=PIXIT_STEPS)
    reset_lstm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(model, task)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches, fit_backward = lstm_launches(), backward_launches()
    reset_lstm()
    t0 = time.perf_counter()
    record = trainer.validate(model, task)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_launches, val_backward = lstm_launches(), backward_launches()
    measured = (launches - PIXIT_EPOCHS * val_launches) \
        / (PIXIT_EPOCHS * PIXIT_STEPS)
    backward_per_step = fit_backward / (PIXIT_EPOCHS * PIXIT_STEPS)
    losses = [h["loss"] for h in trainer.history]
    log(f"(z) Trainer.fit: {PIXIT_EPOCHS} epochs x {PIXIT_STEPS} steps of "
        f"{PIXIT_BATCH} x 5 s in {fit_s:.1f} s; peak {peak / 2**30:.3f} GiB; "
        f"loss per epoch {losses}; der/val/optimal "
        f"{[h.get('der/val/optimal') for h in trainer.history]}; loss/val "
        f"{[h.get('loss/val') for h in trainer.history]}; validation "
        f"{val_s:.2f} s; LSTM launches {launches} in the fit (expected "
        f"{expected}), {val_launches} in one validation, so {measured} per "
        f"step; backward kernel launches {fit_backward} in the fit "
        f"(expected {per_step * PIXIT_EPOCHS * PIXIT_STEPS}), {val_backward} "
        f"in one validation, so {backward_per_step} per step")
    warm = warm_step_report("(z)", trainer, PIXIT_EPOCHS, PIXIT_BATCH,
                            task.duration)
    split = step_split_ms(model, task, trainer,
                          next(task.train_batches(epoch=0)), runs=2)
    log_split("(z)", split)
    if launches != expected or val_launches != per_validation \
            or measured != per_step or backward_per_step != per_step \
            or val_backward:
        raise AssertionError(f"(z) LSTM launches are not {per_step} of "
                             f"each kernel per step")
    if not (all(np.isfinite(losses))
            and np.isfinite(record["der/val/optimal"])
            and np.isfinite(record["loss/val"])):
        raise AssertionError(f"(z) non-finite loss or DER: {losses}, "
                             f"{record}")
    return {"fit_s": fit_s, "peak_bytes": peak, "split_ms": split,
            "launches": launches, "launches_per_step": measured,
            "launches_per_validation": val_launches, "mom_share": shares,
            "backward_launches": fit_backward,
            "backward_launches_per_step": backward_per_step,
            **warm}


def phase_training_more(device, workdir: Path, card: str, protocol) -> dict:
    """Phase 12: training speaker embeddings (y) and PixIT (z)."""
    log(f"phase 12, training embeddings and separation, on {card}")
    check_arcface_step(device, protocol)
    out = {"arcface": check_arcface_run(device, protocol, workdir)}
    torch.cuda.empty_cache()
    check_pixit_step(device, protocol)
    torch.cuda.empty_cache()
    out["pixit"] = check_pixit_run(device, protocol)
    return out


# -- phase 13: the entry points ----------------------------------------------

# (A)-(F) on the community-1 snapshot (its config.yaml) over three files of
# 10, 3 and 1 minutes, the last one sent twice to the server; (C)-(D) on
# two files of (x)'s protocol, registered from a YAML registry
ENTRY_MINUTES = (10.0, 3.0, 1.0)
ENTRY_PROTOCOL = "Synthetic.SpeakerDiarization.Entry"
ENTRY_TOKEN = "entry-token"
ENTRY_TRIALS, ENTRY_RESUMED = 4, 2
# the CLI's DER report against metrics/der on the same outputs and
# references: the same sums, up to the CSV's decimal text
ENTRY_DER_ATOL = 1e-9
WARMUP_SECONDS = 60.0


def cli(*args) -> int:
    """The port's CLI in this process."""
    from pyannote_audio_tpu_torch.__main__ import main as cli_main
    return cli_main([str(a) for a in args])


def check_cli_apply(device, snapshot: Path, wavs: Path, files: list,
                    root: Path) -> int:
    """(A) ``python -m pyannote_audio_tpu_torch apply`` with no --device
    against the same pipeline in this process; the same command without
    a visible card; ``main`` in this process against ``apply_batch``."""
    from pyannote_audio_tpu_torch import Pipeline
    here = Path(__file__).resolve().parent
    command = [sys.executable, "-m", "pyannote_audio_tpu_torch", "apply",
               str(snapshot), str(wavs), "--into"]
    start = time.perf_counter()
    proc = subprocess.run(command + [str(root / "apply")], cwd=here,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"(A) apply exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    pipeline = Pipeline.from_pretrained(snapshot, device=device)
    reset_lstm()
    outputs = pipeline([dict(f) for f in files])
    torch.cuda.synchronize()
    batch_launches = lstm_launches()
    differ = []
    for f, output in zip(files, outputs):
        stem = Path(f["audio"]).stem
        written = json.loads((root / "apply" / f"{stem}.json").read_text())
        rttm = io.StringIO()
        output.speaker_diarization.write_rttm(rttm)
        if written != json.loads(json.dumps(output.serialize())) or \
                (root / "apply" / f"{stem}.rttm").read_text() != \
                rttm.getvalue():
            differ.append(stem)
    log(f"(A) python -m pyannote_audio_tpu_torch apply <snapshot> <3 WAVs, "
        f"{sum(ENTRY_MINUTES):g} min> --into <dir> (no --device): exit 0 "
        f"in {wall:.2f} s wall (a new process: start-up, CUDA context, "
        f"loading, 3 files); RTTM and JSON of {len(files)} files equal to "
        f"the in-process pipeline's: {len(files) - len(differ)} of "
        f"{len(files)} (limit: all){'; differ: ' + str(differ) if differ else ''}")
    if differ:
        raise AssertionError(f"(A) the CLI's outputs differ on {differ}")

    proc = subprocess.run(command + [str(root / "apply-no-card")], cwd=here,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    log(f"(A) the same command with CUDA_VISIBLE_DEVICES=\"\": exit "
        f"{proc.returncode} (limit: not 0), no output files: "
        f"{not (root / 'apply-no-card').exists()}; {last[:200]}")
    if proc.returncode == 0 or (root / "apply-no-card").exists():
        raise AssertionError("(A) apply ran without a card")

    reset_lstm()
    rc = cli("apply", snapshot, wavs, "--into", root / "apply-main")
    torch.cuda.synchronize()
    launches = lstm_launches()
    expected = 2 * len(segmentation_batches(ENTRY_MINUTES))
    log(f"(A) main([\"apply\", ...]) in this process: exit {rc}; "
        f"lstm_recurrence launches {launches}, apply_batch on the same list "
        f"{batch_launches} (limit: equal, and {expected} = 2 layers x "
        f"{expected // 2} batches of {BATCH_SIZE} chunks)")
    if rc != 0 or not launches == batch_launches == expected:
        raise AssertionError("(A) main's launches differ from apply_batch's")

    loaded = cli("download", snapshot)
    hub = cli("download", "pyannote/speaker-diarization-community-1")
    log(f"(A) main([\"download\", <snapshot>]) (no --device: the card) "
        f"exit {loaded} (limit 0); a hub id exit {hub} (limit 1)")
    if loaded != 0 or hub != 1:
        raise AssertionError("(A) download is off")
    return launches


def check_server(device, snapshot: Path, files: list) -> int:
    """(B) DiarizationServer on 127.0.0.1 with a token: four jobs at once
    from the port's client (the three files and a repeat), the SDK, a
    wrong token, a corrupt upload."""
    import urllib.error
    from concurrent.futures import ThreadPoolExecutor

    from pyannote_audio_tpu_torch import Pipeline
    from pyannote_audio_tpu_torch.pipelines.pyannoteai import SDK
    from pyannote_audio_tpu_torch.pipelines.pyannoteai.client import (
        Client, PyannoteAIFailedJob)
    from pyannote_audio_tpu_torch.serve import DiarizationServer
    api_output = DiarizationServer._serialize
    pipeline = Pipeline.from_pretrained(snapshot, device=device)
    expected = {f["audio"]: api_output(pipeline(dict(f))) for f in files}
    server = DiarizationServer(pipeline, host="127.0.0.1", port=0,
                               token=ENTRY_TOKEN).start()
    try:
        client = Client(ENTRY_TOKEN, base_url=server.api_url,
                        poll_interval=0.01, timeout=300.0)
        paths = [f["audio"] for f in files] + [files[-1]["audio"]]
        media = [client.upload(path) for path in paths]

        def request(k):
            start = time.perf_counter()
            job = client.retrieve(client.diarize(media[k]))
            return job, time.perf_counter() - start
        reset_lstm()
        with ThreadPoolExecutor(len(paths)) as pool:
            results = list(pool.map(request, range(len(paths))))
        torch.cuda.synchronize()
        launches = lstm_launches()
        counts = dict(server.counts)
        equal = [job["status"] == "succeeded"
                 and job["output"] == expected[path]
                 for path, (job, _) in zip(paths, results)]
        want = 2 * len(segmentation_batches(ENTRY_MINUTES
                                            + ENTRY_MINUTES[-1:]))
        log(f"(B) DiarizationServer at {server.api_url}: {len(paths)} jobs "
            f"at once (10, 3, 1 min and the 1 min again): "
            f"{sum(equal)} of {len(paths)} succeeded with output == "
            f"pipeline(file).serialize() (limit: all); latency per request "
            f"(diarize to retrieved, 10 ms polls) "
            f"{[round(t, 3) for _, t in results]} s; server counts "
            f"{counts} (limits: batch_failures 0, retried_jobs 0, "
            f"batched_jobs >= 2); lstm_recurrence launches {launches} "
            f"(limit {want})")
        if not all(equal) or counts["batch_failures"] or \
                counts["retried_jobs"] or counts["batched_jobs"] < 2 or \
                launches != want:
            raise AssertionError("(B) the server's jobs did not ride "
                                 "clean batches to the pipeline's outputs")

        sdk = SDK(token=ENTRY_TOKEN)
        sdk._client = client
        start = time.perf_counter()
        output = sdk.apply(files[1]["audio"])
        sdk_s = time.perf_counter() - start
        same = api_output(output) == expected[files[1]["audio"]]
        wrong = Client("wrong", base_url=server.api_url)
        try:
            wrong.diarize(media[0])
            code = 200
        except urllib.error.HTTPError as error:
            code = error.code
        bad = client.upload(b"this is not audio")
        before = dict(server.counts)
        ids = [client.diarize(m) for m in (media[1], bad, media[2])]
        outcomes = []
        for job_id, path in zip(ids, (paths[1], None, paths[2])):
            try:
                job = client.retrieve(job_id)
                outcomes.append(job["output"] == expected[path])
            except PyannoteAIFailedJob:
                outcomes.append("failed" if path is None else False)
        after = {k: server.counts[k] - before[k] for k in before}
        log(f"(B) SDK.apply on the 3 min file in {sdk_s:.3f} s: equal to the "
            f"pipeline's output: {same} (limit True); a wrong token: HTTP "
            f"{code} (limit 401); a corrupt upload between two good ones: "
            f"{outcomes} (limit [True, 'failed', True]), server counts of "
            f"that round {after}")
        if not same or code != 401 or outcomes != [True, "failed", True]:
            raise AssertionError("(B) SDK, auth or job isolation failed")
    finally:
        server.shutdown()
    return launches


def write_entry_registry(root: Path, protocol) -> tuple:
    """Two files of (x)'s protocol as the test and development subsets of
    a pyannote.database registry written by the port's YAML writer."""
    from pyannote_audio_tpu_torch.utils import yaml_subset
    from pyannote_audio_tpu_torch.utils.rttm import dump_rttm, dump_uem
    files = list(protocol.train())[:2]
    dump_rttm({f["uri"]: f["annotation"] for f in files},
              root / "entry.rttm")
    dump_uem({f["uri"]: f["annotated"] for f in files}, root / "entry.uem")
    audio = Path(files[0]["audio"]).parent
    subset = {"annotation": str(root / "entry.rttm"),
              "annotated": str(root / "entry.uem")}
    registry = {"Databases": {"Synthetic": f"{audio}/{{uri}}.wav"},
                "Protocols": {"Synthetic": {"SpeakerDiarization": {"Entry": {
                    "test": subset, "development": dict(subset)}}}}}
    return yaml_subset.dump_file(registry, root / "database.yml"), files


def check_benchmark(device, snapshot: Path, registry: Path,
                    root: Path) -> int:
    """(C) the CLI's benchmark against metrics/der on the same outputs."""
    from pyannote_audio_tpu_torch import Pipeline
    from pyannote_audio_tpu_torch.metrics.der import DiarizationErrorRate
    from pyannote_audio_tpu_torch.utils import yaml_subset
    from pyannote_audio_tpu_torch.utils.database import get_protocol
    into = root / "benchmark"
    reset_lstm()
    start = time.perf_counter()
    rc = cli("benchmark", snapshot, ENTRY_PROTOCOL, into, "--registry",
             registry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = lstm_launches()
    with open(into / "metric.csv") as f:
        rows = {row["uri"]: row for row in csv.DictReader(f)}
    pipeline = Pipeline.from_pretrained(snapshot, device=device)
    metric = DiarizationErrorRate()
    worst = 0.0
    for file in get_protocol(ENTRY_PROTOCOL).test():
        hypothesis = pipeline(dict(file)).speaker_diarization
        components = metric(file["annotation"], hypothesis,
                            uem=file.get("annotated"), detailed=True)
        for key, value in components.items():
            worst = max(worst, abs(float(rows[file["uri"]][key]) - value))
    speed = yaml_subset.load_file(into / "speed.yml")
    total = metric.report()["diarization error rate"]
    log(f"(C) benchmark {ENTRY_PROTOCOL} (2 x {TRAIN_FILE_MINUTES:g} min) "
        f"from a YAML registry: exit {rc} in {wall:.2f} s; its DER report "
        f"against metrics/der on the in-process outputs: largest difference "
        f"{worst:.3e} (limit {ENTRY_DER_ATOL}); DER {total:.4f} (random "
        f"weights); speed.yml read back: {speed}; lstm_recurrence launches "
        f"{launches}")
    if rc != 0 or worst > ENTRY_DER_ATOL or len(rows) != 2 or \
            not speed["seconds_per_hour"] > 0:
        raise AssertionError("(C) the benchmark's report is off")
    return launches


def check_optimize(snapshot: Path, registry: Path, root: Path) -> dict:
    """(D) the CLI's optimize, ENTRY_TRIALS trials then ENTRY_RESUMED
    more from its journal: each run segments and embeds each file once."""
    into = root / "optimize"
    journal = into / "journal.jsonl"
    one_pass = 2 * len(segmentation_batches((TRAIN_FILE_MINUTES,) * 2))
    launches, walls = [], []
    # the resumed run takes another seed: with the first run's, its random
    # startup trials would repeat that run's draws (in the JAX package
    # too: a sampler's generators restart from the seed)
    for trials, seed in ((ENTRY_TRIALS, 42), (ENTRY_RESUMED, 43)):
        reset_lstm()
        start = time.perf_counter()
        rc = cli("optimize", snapshot, ENTRY_PROTOCOL, into, "--registry",
                 registry, "--subset", "test", "--trials", trials, "--seed",
                 seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        launches.append(lstm_launches())
        if rc != 0:
            raise AssertionError("(D) optimize failed")
    trials = [json.loads(line) for line in journal.read_text().splitlines()]
    first = [t["params"] for t in trials[:ENTRY_TRIALS]]
    new = all(t["params"] not in first for t in trials[ENTRY_TRIALS:])
    log(f"(D) optimize, {ENTRY_TRIALS} trials then {ENTRY_RESUMED} resumed "
        f"from the journal, on 2 x {TRAIN_FILE_MINUTES:g} min: journal "
        f"{len(trials)} lines (limit {ENTRY_TRIALS + ENTRY_RESUMED}), trial "
        f"numbers {[t['trial'] for t in trials]}, resumed trials new: {new}"
        f" (limit True); objectives {[round(t['objective'], 4) for t in trials]}"
        f"; lstm_recurrence launches per run {launches} over "
        f"{ENTRY_TRIALS} and {ENTRY_RESUMED} trials (limit: {one_pass} "
        f"each, one pass over the two files; {one_pass * ENTRY_TRIALS} and "
        f"{one_pass * ENTRY_RESUMED} without the training caches); walls "
        f"{[round(w, 2) for w in walls]} s")
    if len(trials) != ENTRY_TRIALS + ENTRY_RESUMED or not new or \
            [t["trial"] for t in trials] != list(range(len(trials))) or \
            launches != [one_pass, one_pass]:
        raise AssertionError("(D) optimize did not resume, or reran the "
                             "models across trials")
    return {f"per run ({ENTRY_TRIALS} and {ENTRY_RESUMED} trials)": launches}


def check_calibration_and_optimizer(root: Path) -> None:
    """(E) Calibration, its file and get_calibration, the TPE optimizer
    and get_devices on this machine's installation, with none of
    scikit-learn, safetensors or PyYAML loaded."""
    from pyannote_audio_tpu_torch.core.calibration import Calibration
    from pyannote_audio_tpu_torch.core.optimizer import (Optimizer,
                                                         TPESampler)
    from pyannote_audio_tpu_torch.core.parameter import (Categorical,
                                                         ParamDict, Uniform)
    from pyannote_audio_tpu_torch.pipelines.utils.getter import (
        get_calibration, get_devices)
    rng = np.random.default_rng(30)
    scores = rng.uniform(0.0, 2.0, 4000)
    labels = (rng.uniform(size=scores.size)
              < 1 / (1 + np.exp(4 * (scores - 1)))).astype(np.float64)
    calibration = Calibration().fit(scores, labels)
    (root / "calibration").mkdir(parents=True, exist_ok=True)
    calibration.save(root / "calibration" / "calibration.safetensors")
    loaded = get_calibration({"checkpoint": str(root / "calibration")})
    grid = np.linspace(-0.5, 2.5, 301)
    test = np.tile(grid, (4, 1))
    test[1, ::7] = np.nan
    a, b = calibration.safe_transform(test), loaded.safe_transform(test)
    err = float(np.nanmax(np.abs(a - b)))
    steps = np.diff(a[0])
    monotone = bool((steps <= 0).all() or (steps >= 0).all())
    inside = bool(np.nanmin(a) >= 0.0 and np.nanmax(a) <= 1.0)
    nan_kept = bool(np.array_equal(np.isnan(a), np.isnan(test)))

    def study():
        space = {"clustering": ParamDict(threshold=Uniform(0.0, 2.0),
                                         method=Categorical(["a", "b"]))}
        opt = Optimizer(space, sampler=TPESampler(seed=3))
        for params in opt.suggestions(30):
            c = params["clustering"]
            opt.tell(params, (c["threshold"] - 0.7) ** 2
                     + (c["method"] == "a"))
        return opt.history, opt.best
    (history, best), again = study(), study()
    devices = get_devices(2)
    loaded_modules = sorted(m for m in sys.modules if m.split(".")[0] in (
        "sklearn", "safetensors", "yaml"))
    log(f"(E) Calibration on 4000 seeded scores ({len(calibration.X_thresholds_)} "
        f"thresholds, increasing {calibration.increasing_}): save -> "
        f"get_calibration(dict) transform difference {err:.1e} (limit 0.0), "
        f"monotone {monotone}, in [0, 1] {inside}, NaN kept {nan_kept}; "
        f"TPE over 30 trials reproducible: {(history, best) == again} "
        f"(best {best[1]:.5f} at {best[0]}); get_devices(2) {devices}; "
        f"sklearn / safetensors / yaml modules loaded: {loaded_modules} "
        f"(limit none)")
    if err != 0.0 or not (monotone and inside and nan_kept) or \
            (history, best) != again or loaded_modules or \
            devices != [torch.device("cuda", 0)] * 2:
        raise AssertionError("(E) calibration, optimizer or imports off")


# (F)'s new process: load the snapshot on the card, optionally warm up,
# then time one apply of a file; prints one JSON line
FIRST_REQUEST = """
import json, sys, time
import torch
from pyannote_audio_tpu_torch import Pipeline
from pyannote_audio_tpu_torch.ops.lstm_kernel import \\
    lstm_bidirectional_recurrence as kernel
snapshot, audio, warmup = sys.argv[1], sys.argv[2], float(sys.argv[3])
times = {}
start = time.perf_counter()
pipeline = Pipeline.from_pretrained(snapshot)
torch.cuda.synchronize()
times["load_s"] = time.perf_counter() - start
kernel.launches = 0
if warmup:
    start = time.perf_counter()
    pipeline.warmup(duration=warmup)
    torch.cuda.synchronize()
    times["warmup_s"] = time.perf_counter() - start
times["warmup_launches"], kernel.launches = kernel.launches, 0
start = time.perf_counter()
output = pipeline({"audio": audio, "uri": "first"})
torch.cuda.synchronize()
times["apply_s"] = time.perf_counter() - start
print(json.dumps(dict(times, launches=kernel.launches,
                      output=output.serialize())))
"""


def first_request(snapshot: Path, audio: str, warmup: float) -> dict:
    """FIRST_REQUEST in a new process (``warmup`` seconds, 0 for none)."""
    proc = subprocess.run(
        [sys.executable, "-c", FIRST_REQUEST, str(snapshot), audio,
         str(warmup)], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"(F) the new process exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_warmup(device, snapshot: Path, file: dict, card: str) -> dict:
    """(F) a cold server's first request: in a new process, apply on the
    1-minute file with and without a warmup(duration=WARMUP_SECONDS)
    before it; both outputs equal this process's pipeline's."""
    from pyannote_audio_tpu_torch import Pipeline
    cold = first_request(snapshot, file["audio"], 0.0)
    warm = first_request(snapshot, file["audio"], WARMUP_SECONDS)
    pipeline = Pipeline.from_pretrained(snapshot, device=device)
    expected = pipeline(dict(file, uri="first")).serialize()
    want = 2 * len(segmentation_batches(ENTRY_MINUTES[-1:]))
    want_warmup = 2 * len(segmentation_batches((WARMUP_SECONDS / 60,)))
    log(f"(F) the first request of a new process, on the 1-minute file "
        f"({card}): cold {cold['apply_s']:.3f} s (after loading "
        f"{cold['load_s']:.3f} s); after warmup(duration="
        f"{WARMUP_SECONDS:g}) of {warm['warmup_s']:.3f} s (loading "
        f"{warm['load_s']:.3f} s) {warm['apply_s']:.3f} s; outputs equal "
        f"to this process's pipeline's: {cold['output'] == expected}, "
        f"{warm['output'] == expected} (limit True, True); lstm_recurrence "
        f"launches: apply {cold['launches']} and {warm['launches']} (limit "
        f"{want}), warmup {warm['warmup_launches']} (limit {want_warmup})")
    if not cold["output"] == warm["output"] == expected or \
            not cold["launches"] == warm["launches"] == want or \
            warm["warmup_launches"] != want_warmup:
        raise AssertionError("(F) the first request is off")
    return {"cold apply": cold["launches"],
            "warmup": warm["warmup_launches"],
            "apply after warmup": warm["launches"]}


def phase_entry_points(device, workdir: Path, card: str, protocol) -> dict:
    """Phase 13: the CLI, the server, benchmark, optimize, calibration and
    warmup on the community-1 snapshot; returns each path's launches."""
    log(f"phase 13, the entry points, on {card}")
    set_gates(None)
    start = time.perf_counter()
    root = workdir / "entry"
    snapshot = root / "snapshot"
    write_community_snapshot(snapshot)
    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    files = write_files(wavs, ENTRY_MINUTES)
    registry, _ = write_entry_registry(root, protocol)
    launches = {"CLI apply (A)": check_cli_apply(device, snapshot, wavs,
                                                 files, root)}
    launches["server (B)"] = check_server(device, snapshot, files)
    launches["CLI benchmark (C)"] = check_benchmark(device, snapshot,
                                                    registry, root)
    launches["CLI optimize (D)"] = check_optimize(snapshot, registry, root)
    check_calibration_and_optimizer(root)
    launches["first request (F)"] = check_warmup(device, snapshot,
                                                 files[-1], card)
    log(f"phase 13 took {time.perf_counter() - start:.1f} s")
    return launches


# -- phase 14: data parallelism and hub resolution --------------------------

# (G) one process, a mesh of two slots on the one card: every batch splits
# into two shards (replicas on a repeated device are one module), so the
# LSTM kernel launches twice per batch and layer
MESH_DEVICES = ("cuda:0", "cuda:0")
# (G2) a mesh of two distinct devices, the card and the CPU, on the
# 1-minute file: the CPU's replicas are copies, every shard's inputs cross
# devices and the outputs gather on the card. Float32 on both
# (PYANNOTE_TPU_SEG_BF16=0, a float32 ResNet34), so that the CPU's half
# differs from the card's by summation order only, held by the near-tie
# rule of (g)-(i)
CROSS_DEVICES, CROSS_MINUTES = ("cuda:0", "cpu"), 1.0
# (H) DDP, two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
# GPU), and (H1) one rank over NCCL: (x)'s PyanNet on its protocol, a
# global batch of 32 (16 per rank), 1 epoch of 3 steps and one validation,
# against the single-process fit of the same seed. Both fits run SincNet
# in float32 (PYANNOTE_TPU_SEG_BF16=0) with cuDNN's deterministic
# algorithms, so that they differ by the split alone: the losses and
# der/val within the JAX package's mesh-fit bound (tests/test_train.py,
# rel 1e-4) for two ranks, and within 1e-6 for one rank, whose only
# difference is DDP's all-reduce of one gradient
DDP_WORLD, DDP_BATCH, DDP_STEPS = 2, 32, 3
DDP_LOSS_RTOL, NCCL_LOSS_RTOL = 1e-4, 1e-6
# every spawn joins within its own timeout; a collective one rank never
# reaches fails its group before that
SPAWN_TIMEOUT_S, GROUP_TIMEOUT_S = 400.0, 180.0
HUB_ID = "pyannote/speaker-diarization-community-1"


def check_mesh_inference(device, workdir: Path, card: str) -> dict:
    """(G) SpeakerDiarization on a MESH_DEVICES mesh against the same
    models without one, on the accelerator path: 10 + 3 min through
    ``apply_batch`` and file by file (launches, paths, warm walls, peaks),
    each file held to the single-device run by the near-tie rule."""
    from pyannote_audio_tpu_torch.parallel import make_mesh
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    set_gates(None)
    segmentation, embedding = make_models(torch.bfloat16)
    single = build_pipeline(segmentation, embedding, device)
    mesh = make_mesh(devices=list(MESH_DEVICES))
    sharded = SpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=BATCH_SIZE, embedding_batch_size=BATCH_SIZE,
        mesh=mesh).instantiate(PARAMS)
    files = write_files(workdir, FILE_MINUTES)
    result = {}
    for name, pipeline in (("single", single), ("mesh", sharded)):
        run_batch(pipeline, files)                  # warm: plans, kernel
        torch.cuda.synchronize()
        reset_counts(pipeline)
        peak, wall = peak_and_wall(device, lambda: run_batch(pipeline,
                                                             files))
        counts = read_counts(pipeline)
        one_by_one = wall_seconds(lambda: run_one_by_one(pipeline, files))
        result[name] = {"counts": counts, "wall_s": wall,
                        "file_by_file_s": one_by_one, "peak_bytes": peak}
        log(f"(G) {name}{' ' + repr(mesh) if name == 'mesh' else ''}: "
            f"{sum(FILE_MINUTES):g} min through apply_batch {wall:.3f} s "
            f"warm, file by file {one_by_one:.3f} s; peak "
            f"{peak / 2**30:.3f} GiB; counts {counts} ({card})")
    a, b = result["mesh"]["counts"], result["single"]["counts"]
    expected = dict(b, lstm_launches=2 * b["lstm_launches"],
                    trunk_panel_batches=2 * b["trunk_panel_batches"])
    log(f"(G) mesh counts {a} (expected {expected}: two shards per "
        f"segmentation and trunk-panel batch, one whole-file conv and "
        f"fbank per file)")
    if a != expected:
        raise AssertionError("(G) the mesh did not split every batch")
    batch_outputs = run_batch(sharded, files)
    check_outputs(files, batch_outputs)
    frames = segmentation.receptive_field
    for f, from_batch in zip(files, batch_outputs):
        ours, theirs = traced_run(sharded, f), traced_run(single, f)
        if from_batch.speaker_diarization != ours[0].speaker_diarization:
            raise AssertionError(f"(G) {f['uri']}: apply_batch and apply "
                                 f"differ under the mesh")
        waveform = single._audio(dict(f))[0]
        check_same_diarization(f"(G) {f['uri']} mesh vs single", ours,
                               theirs, logprobs(sharded, waveform),
                               logprobs(single, waveform), frames)
    return {"launches": a["lstm_launches"], "single": result["single"],
            "mesh": result["mesh"]}


def same_weights(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    return all(torch.equal(p.detach().cpu(), q.detach().cpu())
               for p, q in zip(a.parameters(), b.parameters()))


def check_mesh_across_devices(device, workdir: Path, card: str) -> dict:
    """(G2) SpeakerDiarization on a CROSS_DEVICES mesh against the same
    models on the card alone, on CROSS_MINUTES: the CPU's replicas are
    copies with the card's weights, copied afresh by ``to``; the LSTM
    kernel launches for the card's shards alone, as often as on the card
    alone (one shard per batch); the outputs are held by the near-tie
    rule."""
    from pyannote_audio_tpu_torch.parallel import make_mesh
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    set_gates(None)
    segmentation, embedding = make_models(torch.float32)
    mesh = make_mesh(devices=list(CROSS_DEVICES))
    [file] = write_files(workdir, (CROSS_MINUTES,))
    with environ({"PYANNOTE_TPU_SEG_BF16": "0"}):
        single = build_pipeline(segmentation, embedding, device)
        crossed = SpeakerDiarization(
            segmentation=segmentation, embedding=embedding,
            clustering="AgglomerativeClustering",
            segmentation_batch_size=BATCH_SIZE,
            embedding_batch_size=BATCH_SIZE, mesh=mesh).instantiate(PARAMS)

        def copies():
            return (crossed._segmentation._replicas[1],
                    crossed._embedding_replicas[1])
        before = copies()
        crossed.to(device)
        after = copies()
        copied = all(
            c is not m and next(c.parameters()).device.type == "cpu"
            and same_weights(c, m) for c, m in
            zip(before + after, (segmentation, embedding) * 2)) \
            and all(a is not b for a, b in zip(after, before))
        runs = {}
        for name, pipeline in (("mesh", crossed), ("single", single)):
            traced_run(pipeline, file)                  # warm
            reset_counts(pipeline)
            start = time.perf_counter()
            runs[name] = traced_run(pipeline, file)
            torch.cuda.synchronize()
            runs[name] += (time.perf_counter() - start, read_counts(pipeline))
        waveform = single._audio(dict(file))[0]
        logp = {name: logprobs(pipeline, waveform).cpu()
                for name, pipeline in (("mesh", crossed), ("single", single))}
    counts, single_counts = runs["mesh"][3], runs["single"][3]
    log(f"(G2) {mesh}: replicas on the CPU are copies with the card's "
        f"weights, copied afresh by to(): {copied}; {CROSS_MINUTES:g} min "
        f"{runs['mesh'][2]:.3f} s warm against {runs['single'][2]:.3f} s on "
        f"the card alone; counts {counts} against {single_counts} ({card})")
    if not copied:
        raise AssertionError("(G2) the CPU replicas are not copies of the "
                             "card's models")
    if counts["lstm_launches"] != single_counts["lstm_launches"] or \
            not counts["lstm_launches"] or \
            counts["trunk_panel_batches"] < \
            single_counts["trunk_panel_batches"]:
        raise AssertionError("(G2) the card's shards did not launch as the "
                             "card alone does")
    check_same_diarization(f"(G2) {file['uri']} card + CPU vs card",
                           runs["mesh"][:2], runs["single"][:2], logp["mesh"],
                           logp["single"], segmentation.receptive_field)
    check_outputs([file], [runs["mesh"][0]])
    return {"launches": counts["lstm_launches"], "wall_s": runs["mesh"][2],
            "single_wall_s": runs["single"][2]}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(fn, world: int, args: tuple, label: str) -> None:
    """``fn(rank, world, port, *args)`` in ``world`` processes of
    ``torch.multiprocessing.spawn``; each is killed, and the check fails,
    past SPAWN_TIMEOUT_S."""
    context = torch.multiprocessing.spawn(
        fn, args=(world, _free_port()) + args, nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            raise AssertionError(f"{label}: the ranks did not finish in "
                                 f"{SPAWN_TIMEOUT_S} s")


def ddp_fit(device, protocol, workdir: Path, mesh=None) -> dict:
    """The fit of (H) / (H1): (x)'s PyanNet (seed 2), DDP_STEPS steps of
    DDP_BATCH chunks and one validation; the rank's losses, record,
    launches, weights and wall."""
    from pyannote_audio_tpu_torch.train import Trainer
    from pyannote_audio_tpu_torch.train import trainer as trainer_module
    # count this process's checkpoint writes (rank 0 alone writes)
    writes, save = [], trainer_module.save_checkpoint

    def counted_save(model, path):
        writes.append(Path(path).name)
        return save(model, path)
    trainer_module.save_checkpoint = counted_save
    task = training_task(protocol, batch_size=DDP_BATCH,
                         cache=str(workdir / f"cache_rank{mesh.rank}")
                         if mesh is not None else None)
    model = published_pyannet(seed=2)
    trainer = Trainer(max_epochs=1, limit_train_batches=DDP_STEPS,
                      learning_rate=TRAIN_LR, mesh=mesh,
                      device=None if mesh is not None else device,
                      checkpoint_dir=workdir / "checkpoints")
    reset_lstm()
    torch.cuda.synchronize()
    start = time.perf_counter()
    try:
        trainer.fit(model, task)
    finally:
        trainer_module.save_checkpoint = save
    torch.cuda.synchronize()
    return {"losses": trainer.step_losses, "history": trainer.history,
            "writes": writes,
            "launches": lstm_launches(),
            "backward_launches": backward_launches(),
            "wall_s": time.perf_counter() - start, "cache": task.cache,
            "params": {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()}}


def ddp_worker(rank: int, world: int, port: int, backend: str, protocol,
               workdir: str) -> None:
    """One rank of (H) / (H1) on cuda:0: the group, ``make_mesh()``,
    ``broadcast_from_host0`` and the fit; its results under
    ``workdir/rank{rank}.pt``."""
    import datetime
    import torch.distributed as dist
    from pyannote_audio_tpu_torch.parallel import (broadcast_from_host0,
                                                   make_mesh)
    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = make_mesh()
        result = ddp_fit(torch.device("cuda", 0), protocol, Path(workdir),
                         mesh)
        result["broadcast"] = broadcast_from_host0(f"rank {rank}'s value")
        result["mesh"] = repr(mesh)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def hold_fit(label: str, ours: dict, theirs: dict, rtol: float) -> float:
    """The largest relative difference of the per-step losses, the epoch
    loss and the validation record (der/val, its optimal value, loss/val)
    of ``ours`` against ``theirs``; raises past ``rtol``."""
    pairs = list(zip(ours["losses"], theirs["losses"]))
    for key in ("loss", "der/val", "der/val/optimal", "loss/val"):
        pairs.append((ours["history"][0][key], theirs["history"][0][key]))
    worst = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    keys = ("loss", "der/val", "der/val/optimal", "loss/val")
    log(f"{label}: per-step losses {ours['losses']} vs {theirs['losses']}; "
        f"epoch loss, der/val, der/val/optimal, loss/val "
        f"{[ours['history'][0][k] for k in keys]} vs "
        f"{[theirs['history'][0][k] for k in keys]}, relative difference at "
        f"most {worst:.3e} (limit {rtol})")
    if len(ours["losses"]) != DDP_STEPS or not worst <= rtol:
        raise AssertionError(f"{label}: the fit differs from the "
                             f"single-process fit")
    return worst


def check_ddp(device, protocol, workdir: Path, card: str) -> dict:
    """(H) two gloo ranks and (H1) one NCCL rank on cuda:0 against the
    single-process fit: losses, record, launches, checkpoints written
    once, broadcast_from_host0, walls."""
    from pyannote_audio_tpu_torch.core.model import Model
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with environ({"PYANNOTE_TPU_SEG_BF16": "0"}):
            single = ddp_fit(device, protocol, workdir / "ddp_single")
            out = {}
            for label, backend, world in (("(H)", "gloo", DDP_WORLD),
                                          ("(H1)", "nccl", 1)):
                root = workdir / f"ddp_{backend}"
                root.mkdir(parents=True)
                start = time.perf_counter()
                run_ranks(ddp_worker, world, (backend, protocol, str(root)),
                          label)
                wall = time.perf_counter() - start
                ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
                         for r in range(world)]
                out[label] = {"ranks": ranks, "wall_s": wall, "root": root}
    finally:
        torch.backends.cudnn.deterministic = saved
    record = {"single_wall_s": single["wall_s"],
              "single_launches": single["launches"],
              "single_backward_launches": single["backward_launches"]}
    for label, tol in (("(H)", DDP_LOSS_RTOL), ("(H1)", NCCL_LOSS_RTOL)):
        ranks, root = out[label]["ranks"], out[label]["root"]
        world = len(ranks)
        worst = hold_fit(f"{label} {world} rank(s) vs one process", ranks[0],
                         single, tol)
        same = all(r["losses"] == ranks[0]["losses"]
                   and r["history"] == ranks[0]["history"]
                   and all(torch.equal(p, ranks[0]["params"][n])
                           for n, p in r["params"].items()) for r in ranks)
        caches = {r["cache"] for r in ranks}
        broadcasts = {r["broadcast"] for r in ranks}
        writes = [r["writes"] for r in ranks]
        reloaded = Model.from_pretrained(root / "checkpoints" / "epoch_0")
        reloads = all(torch.equal(p.detach(), ranks[0]["params"][n])
                      for n, p in reloaded.named_parameters())
        # each rank, as the single process: 2 layers per step (on its
        # share of the batch) and per validation batch (padded to the
        # batch size, so every rank's share holds chunks)
        launches = [r["launches"] for r in ranks]
        expected = single["launches"]
        backward = [r["backward_launches"] for r in ranks]
        expected_backward = 2 * DDP_STEPS
        log(f"{label} {ranks[0]['mesh']}: ranks agree on losses, record and "
            f"weights: {same}; cache path on every rank {caches} (rank 0's: "
            f"{str(root / 'cache_rank0')}), broadcast_from_host0 "
            f"{broadcasts}; checkpoints written per rank {writes} (single "
            f"process {single['writes']}), the epoch checkpoint reloads rank "
            f"0's weights: {reloads}; lstm_recurrence "
            f"launches per rank {launches} (expected {expected}; single "
            f"process {single['launches']}), lstm_recurrence_backward "
            f"launches per rank {backward} (expected {expected_backward}: 2 "
            f"per step; single process {single['backward_launches']}); "
            f"{out[label]['wall_s']:.1f} s "
            f"wall with start-up (the fit {ranks[0]['wall_s']:.1f} s, one "
            f"process {single['wall_s']:.1f} s) on {card}")
        if not (same and caches == {str(root / "cache_rank0")}
                and broadcasts == {"rank 0's value"}
                and writes[0] == single["writes"] and not any(writes[1:])
                and reloads and all(n == expected for n in launches)
                and single["backward_launches"] == expected_backward
                and all(n == expected_backward for n in backward)):
            raise AssertionError(f"{label}: the ranks do not agree, or "
                                 f"wrote more than once")
        record[label] = {"max_rel_diff": worst, "launches": launches,
                         "backward_launches": backward,
                         "wall_s": out[label]["wall_s"],
                         "fit_s": ranks[0]["wall_s"]}
    return record


class HubServer:
    """``http.server`` on 127.0.0.1 serving the hub's
    ``/{org}/{name}/resolve/{revision}/{path}`` from ``root/{org}/{name}/``
    (revision ignored); ``requests`` counts what it served."""

    def __init__(self, root: Path):
        import http.server
        import threading
        self.requests = []
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                path = root.joinpath(parts[0], parts[1], *parts[4:]) \
                    if len(parts) > 4 and parts[2] == "resolve" else None
                if path is None or not path.is_file():
                    self.send_error(404)
                    return
                data = path.read_bytes()
                server.requests.append(self.path)
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def check_hub(device, workdir: Path, config: dict) -> None:
    """(I) ``Pipeline.from_pretrained(HUB_ID)`` through a PYANNOTE_TPU_HUB
    root holding (l)'s snapshot, then over HTTP from a 127.0.0.1 server
    into an empty cache; each on a 1-minute file against the pipeline
    loaded from the snapshot's directory."""
    from pyannote_audio_tpu_torch import Pipeline
    snapshot = Path(config["checkpoint"])
    roots = workdir / "hub_roots"
    (roots / HUB_ID).parent.mkdir(parents=True)
    (roots / HUB_ID).symlink_to(snapshot)
    file = write_files(workdir, (1.0,))[0]
    expected = Pipeline.from_pretrained(snapshot, device=device)(dict(file))
    server = HubServer(roots)
    try:
        for route, env in (
                ("PYANNOTE_TPU_HUB root",
                 {"PYANNOTE_TPU_HUB": str(roots),
                  "PYANNOTE_TPU_CACHE": str(workdir / "hub_cache_roots")}),
                (f"HTTP {server.endpoint} into an empty cache",
                 {"PYANNOTE_TPU_HUB": "", "HF_ENDPOINT": server.endpoint,
                  "PYANNOTE_TPU_CACHE": str(workdir / "hub_cache_http")})):
            served = len(server.requests)
            with environ(env):
                start = time.perf_counter()
                pipeline = Pipeline.from_pretrained(HUB_ID, device=device)
                load_s = time.perf_counter() - start
                output = pipeline(dict(file))
            same = output.speaker_diarization == \
                expected.speaker_diarization and np.array_equal(
                    output.speaker_embeddings, expected.speaker_embeddings)
            log(f"(I) Pipeline.from_pretrained({HUB_ID!r}) through the "
                f"{route}: loaded in {load_s:.2f} s, "
                f"{len(server.requests) - served} file(s) served; on 1 min "
                f"equal to the pipeline loaded from its directory: {same}")
            if not same:
                raise AssertionError(f"(I) the hub route {route} differs")
        if len(server.requests) < 4:
            raise AssertionError("(I) the HTTP route fetched too little: "
                                 f"{server.requests}")
    finally:
        server.close()


def phase_parallel_and_hub(device, workdir: Path, card: str, protocol,
                           config: dict) -> dict:
    """Phase 14: (G) inference over a mesh, (H) / (H1) DDP training and
    (I) hub resolution; returns each path's launches."""
    log(f"phase 14, data parallelism and hub resolution, on {card}")
    root = workdir / "parallel"
    root.mkdir(parents=True)
    start = time.perf_counter()
    mesh = check_mesh_inference(device, root, card)
    mesh["(G2)"] = check_mesh_across_devices(device, root, card)
    ddp = check_ddp(device, protocol, root, card)
    check_hub(device, root, config)
    log(f"phase 14 took {time.perf_counter() - start:.1f} s")
    return {"mesh (G)": mesh["launches"],
            "mesh across devices (G2)": mesh["(G2)"]["launches"],
            "DDP (H) per rank": ddp["(H)"]["launches"],
            "DDP (H) per rank, backward": ddp["(H)"]["backward_launches"],
            "DDP (H1)": ddp["(H1)"]["launches"],
            "DDP (H1), backward": ddp["(H1)"]["backward_launches"],
            "phase 14": {"mesh": mesh, "ddp": ddp}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    walls = {}
    # hub ids resolve through utils/hf_hub.py: no snapshot root and a
    # closed local endpoint unless a check sets its own
    os.environ.update({"HF_ENDPOINT": "http://127.0.0.1:9",
                       "PYANNOTE_TPU_HUB": ""})

    def timed(name, fn, *args):
        """``fn(*args)``, its wall time kept under ``name``."""
        start = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - start, 1)
        return out

    card = timed("1 environment", phase_environment)
    timed("2 build", phase_build)
    if sys.argv[1:] == ["tf32x3"]:
        print(json.dumps({"tf32x3": timed("3c tf32x3", phase_tf32x3,
                                          device, card),
                          "phase_walls_s": walls}))
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke.py: unknown arguments {sys.argv[1:]}")
    record = timed("3 kernels", phase_kernels, device)
    record["tf32x3"] = timed("3c tf32x3", phase_tf32x3, device, card)
    record["training_shape"] = timed("3 kernels under autograd",
                                     check_kernel_autograd, device)
    backward = record["training_shape"].pop("backward_kernel")
    wide = timed("3 kernels streamed (H > 256)", check_wide_kernels, device)
    record["streamed"] = {"shapes": wide["forward"],
                          "max_abs_err": wide["forward_max_abs_err"]}
    backward["streamed"] = {"shapes": wide["backward"],
                            "grad_rel_l2": wide["backward_grad_rel_l2"],
                            "max_abs_err": wide["backward_max_abs_err"],
                            "autograd": wide["autograd"]}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        os.environ["PYANNOTE_TPU_CACHE"] = str(work / "hub_cache")
        launches["exact"] = timed("4 exact path", phase_exact, device, work)
        launches[f"exact, H = {WIDE_PIPELINE_HIDDEN}"] = timed(
            f"4 exact path H = {WIDE_PIPELINE_HIDDEN}", phase_wide_lstm,
            device, work)
        pipeline, launches["accelerator"] = timed(
            "5 accelerator path", phase_accelerator, device, work)
        timed("6 serving", phase_serving, pipeline, device, work)
        timed("7 (k) default flags", phase_default_flags, device)
        launches["community-1 (VBx)"], config = timed(
            "7 (l) community-1", phase_community, device, work, pipeline)
        launches.update(timed("8 VAD, multilabel, audio",
                              phase_vad_multilabel_audio, device, work,
                              pipeline, config))
        launches.update(timed("9 embedders", phase_embedders, device, work,
                              config, card))
        launches.update(timed("10 SSeRiouSS, separation", phase_separation,
                              device, work, card))
        protocol = timed("11 protocol", write_training_protocol, work)
        training = timed("11 training (x)", phase_training, device, work,
                         card, protocol)
        launches["training (x)"] = {
            "per step": training["launches_per_step"],
            "per validation": training["launches_per_validation"],
            "fit": training["launches"],
            "backward per step": training["backward_launches_per_step"],
            "backward fit": training["backward_launches"]}
        launches[f"training (x) step, H = {WIDE_PIPELINE_HIDDEN}"] = {
            "forward": training["wide_step"]["launches"],
            "backward": training["wide_step"]["backward_launches"]}
        launches["evaluate (x)"] = training["evaluate"]["launches"]
        record["training"] = training
        more = timed("12 training (y), (z)", phase_training_more, device,
                     work, card, protocol)
        launches["arcface (y)"] = {"fit": more["arcface"]["launches"]}
        launches["pixit (z)"] = {
            "per step": more["pixit"]["launches_per_step"],
            "per validation": more["pixit"]["launches_per_validation"],
            "fit": more["pixit"]["launches"],
            "backward per step": more["pixit"]["backward_launches_per_step"],
            "backward fit": more["pixit"]["backward_launches"]}
        record["training_embedding"] = more["arcface"]
        record["training_pixit"] = more["pixit"]
        launches.update(timed("13 entry points", phase_entry_points, device,
                              work, card, protocol))
        parallel = timed("14 parallel, hub", phase_parallel_and_hub, device,
                         work, card, protocol, config)
        record["phase14"] = parallel.pop("phase 14")
        launches.update(parallel)
    log(f"LSTM kernel launches per path (lstm_recurrence; "
        f"lstm_recurrence_backward where named): {launches}")
    log(f"wall per phase, s ({card}): {walls}; total "
        f"{sum(walls.values()):.1f}")
    record["launches"] = launches["accelerator"]
    record["launches_per_path"] = launches
    record["phase_walls_s"] = walls
    # the backward kernel's main path is training: (x)'s fit
    backward["launches"] = launches["training (x)"]["backward fit"]
    print(json.dumps({"kernels": [record, backward]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
