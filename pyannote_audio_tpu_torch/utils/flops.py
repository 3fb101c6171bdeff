"""Analytic FLOP counts of the diarization path, and the device memory one
file pins while in flight.

Counterpart of pyannote_audio_tpu/utils/flops.py, count for count: the
same arguments give the same integers in both packages, so a benchmark
can divide a count by a measured wall for an achieved rate. 1 MAC = 2
FLOPs; elementwise, normalisation and pooling work is left out; counts
are nominal (a float32 product is counted once whatever route computes
it). No peak rate of any device is stated here.

The counts model what the JAX package executes, and the port executes
otherwise in places (a benchmark reading them must allow for it):

- Segmentation batches: the JAX count pads a file's last batch of
  chunks to 128 when it holds at most 128 of 256, else to 256
  (``_tail_padded``, its ``PYANNOTE_TPU_TAIL_HALF_BATCH`` gate
  included). The port runs the real tail (a 591-chunk file runs 256 +
  256 + 79 chunks), so its executed segmentation work is
  ``per_chunk * chunks``, at most the count's.
- Whole-file buffers: the JAX count pads the waveform to 30 s buckets
  and runs the sinc conv and the fbank over the padded length. The port
  pads only to the chunk grid (``core/inference.py`` ``pad_to_grid``:
  (chunks - 1) * step + window samples), so its sinc conv and fbank run
  over up to 30 s less than counted.
- The trunk: both run whole batches of 8 panels of 512 core frames with
  64-frame halos on each side (``pipelines/speaker_diarization.py``
  ``TRUNK_PANEL_*``), the port over its grid-padded fbank frames, so at
  most the count's panel batches.
- The per-chunk (exact) path runs SincNet and the trunk per chunk and is
  not what ``diarization_device_flops`` counts.

``diarization_resident_hbm_bytes`` (read by the long-file slice plan,
``core/longfile.py``) is kept term for term with the JAX package's: the
same file then gets the same slice plan in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

SINC_KERNEL = 251
SINC_FILTERS = 80


def conv1d_flops(frames_out: int, kernel: int, cin: int, cout: int) -> int:
    """Dense 1-D convolution: 2 * K * Cin * Cout * frames_out."""
    return 2 * kernel * cin * cout * frames_out


def conv2d_flops(h_out: int, w_out: int, kh: int, kw: int,
                 cin: int, cout: int) -> int:
    """Dense 2-D convolution: 2 * kh * kw * Cin * Cout per output pixel."""
    return 2 * kh * kw * cin * cout * h_out * w_out


def lstm_flops(seq_len: int, input_sizes: Sequence[int], hidden: int,
               bidirectional: bool = True) -> int:
    """The gate products only, 4H x (I + H) per step and direction for
    each layer's input size I (the gate math is about 1 % of it)."""
    dirs = 2 if bidirectional else 1
    macs_per_step = sum(4 * hidden * (i + hidden) for i in input_sizes)
    return 2 * macs_per_step * dirs * seq_len


def conv1d_out(n: int, kernel: int, stride: int = 1) -> int:
    """VALID conv / pool output length."""
    return (n - kernel) // stride + 1 if n >= kernel else 0


def sincnet_whole_conv_flops(num_samples: int, stride: int = 10) -> int:
    """The shared front-end: one sinc conv over the (padded) whole file."""
    return conv1d_flops(conv1d_out(num_samples, SINC_KERNEL, stride),
                        SINC_KERNEL, 1, SINC_FILTERS)


def pyannet_post_sinc_flops(window_samples: int = 160000,
                            stride: int = 10,
                            lstm_hidden: int = 128,
                            lstm_layers: int = 2,
                            linear_hidden: int = 128,
                            linear_layers: int = 2,
                            dimension: int = 7) -> Dict[str, int]:
    """A chunk's work after the shared sinc conv: SincNet's two 60-filter
    convs ("convs"), the BiLSTM ("lstm") and the linear head ("head"),
    with the LSTM's sequence length ("frames")."""
    f = conv1d_out(window_samples, SINC_KERNEL, stride)
    f = f // 3                                            # max-pool 3
    conv1 = conv1d_flops(conv1d_out(f, 5), 5, SINC_FILTERS, 60)
    f = conv1d_out(f, 5) // 3
    conv2 = conv1d_flops(conv1d_out(f, 5), 5, 60, 60)
    f = conv1d_out(f, 5) // 3                             # LSTM frames
    inputs = [60] + [2 * lstm_hidden] * (lstm_layers - 1)
    lstm = lstm_flops(f, inputs, lstm_hidden, bidirectional=True)
    widths = [2 * lstm_hidden] + [linear_hidden] * linear_layers
    head = 2 * f * sum(a * b for a, b in
                       zip(widths, widths[1:] + [dimension]))
    return {"convs": conv1 + conv2, "lstm": lstm, "head": head,
            "frames": f}


def fbank_conv_flops(num_frames: int, window: int = 400,
                     padded: int = 512, num_mel_bins: int = 80) -> int:
    """The composed-conv fbank: one (window, 2 * (padded / 2 + 1))
    strided conv and the (frequency, mel) product."""
    nk = padded // 2 + 1
    dft = conv1d_flops(num_frames, window, 1, 2 * nk)
    mel = 2 * num_frames * nk * num_mel_bins
    return dft + mel


def resnet_trunk_flops_per_frame(m_channels: int = 32,
                                 num_blocks: Sequence[int] = (3, 4, 6, 3),
                                 freq: int = 80,
                                 bottleneck: bool = False) -> int:
    """The WeSpeaker ResNet trunk's FLOPs per input fbank frame (its time
    axis scales linearly): a 3x3 stem, then four stages at channel
    multipliers (1, 2, 4, 8) and strides (1, 2, 2, 2) on both time and
    frequency, basic blocks or (``bottleneck``) bottleneck blocks."""
    total = float(conv2d_flops(1, freq, 3, 3, 1, m_channels))  # stem
    cin = m_channels
    t_scale = 1.0
    w = freq
    for blocks, mult, stride in zip(num_blocks, (1, 2, 4, 8), (1, 2, 2, 2)):
        mid = m_channels * mult
        cout = mid * (4 if bottleneck else 1)
        for b in range(blocks):
            s = stride if b == 0 else 1
            area_in = t_scale * w
            t_scale /= s
            w = -(-w // s)
            area_out = t_scale * w
            if bottleneck:
                # 1x1 at full resolution, 3x3 of stride s, 1x1
                total += area_in * 2 * cin * mid
                total += area_out * (2 * 9 * mid * mid + 2 * mid * cout)
            else:
                # 3x3 of stride s, 3x3
                total += area_out * (2 * 9 * cin * mid + 2 * 9 * mid * mid)
            if s != 1 or cin != cout:
                total += area_out * 2 * cin * cout      # 1x1 shortcut
            cin = cout
    return int(total)


def _tail_pad_to(batch_size: int, n_real: int) -> int:
    """The JAX package's padded size of a batch of ``n_real`` chunks: a
    tail of at most half a batch pads to the half
    (``PYANNOTE_TPU_TAIL_HALF_BATCH``, "1" by default), else to the
    whole batch."""
    half = batch_size // 2
    half_ok = half >= 1 and \
        os.environ.get("PYANNOTE_TPU_TAIL_HALF_BATCH", "1") == "1"
    return half if (n_real <= half and half_ok) else batch_size


def _tail_padded(n_chunks: int, batch: int = 256) -> int:
    """Chunks the JAX package executes for ``n_chunks``: whole batches and
    the padded tail."""
    full, rem = divmod(n_chunks, batch)
    if rem == 0:
        return n_chunks
    return full * batch + _tail_pad_to(batch, rem)


def diarization_device_flops(
        file_seconds: float,
        sample_rate: int = 16000,
        window: float = 10.0,
        step: float = 1.0,
        batch: int = 256,
        local_speakers: int = 3,
        trunk_core: int = 512,
        trunk_halo: int = 64,
        trunk_pbatch: int = 8,
        trunk_stride: int = 8,
        embed_dim: int = 256,
) -> Dict[str, int]:
    """Per-stage FLOPs of one file through SpeakerDiarization (PyanNet
    powerset, WeSpeaker ResNet34, clustering) on the accelerator path:
    the shared sinc front-end, the whole-file fbank and trunk panels, and
    segmentation in batches of ``batch`` with the JAX package's padded
    tail (see the module's docstring for what the port executes)."""
    n = int(file_seconds * sample_rate)
    win = int(window * sample_rate)
    hop = int(step * sample_rate)
    num_full = 1 + (n - win) // hop if n >= win else 0
    has_last = (n < win) or ((n - win) % hop > 0)
    n_chunks = num_full + int(has_last)
    needed = (n_chunks - 1) * hop + win
    bucket = 30 * sample_rate
    padded = max(needed, -(-needed // bucket) * bucket)     # 30 s buckets
    executed = _tail_padded(n_chunks, batch)

    seg = pyannet_post_sinc_flops(win)
    per_chunk = seg["convs"] + seg["lstm"] + seg["head"]

    fbank_frames = conv1d_out(padded, 400, 160)
    trunk_total = -(-fbank_frames // trunk_stride)
    n_panels = -(-trunk_total // trunk_core)
    n_pbatches = -(-n_panels // trunk_pbatch)
    panel_in = (trunk_core + 2 * trunk_halo) * trunk_stride
    trunk_frames_executed = n_pbatches * trunk_pbatch * panel_in
    per_frame = resnet_trunk_flops_per_frame()
    # masked statistics pooling + seg_1 per (chunk, speaker): 256 channels
    # x 10 frequencies = 2560 pooled, mean and std into embed_dim
    pool_dim = 2560
    pool = executed * local_speakers * (
        2 * (int(window / 0.01) // trunk_stride) * pool_dim
        + 2 * 2 * pool_dim * embed_dim)

    return {
        "sinc_whole_conv": sincnet_whole_conv_flops(padded),
        "segmentation": per_chunk * executed,
        "fbank": fbank_conv_flops(fbank_frames),
        "trunk": per_frame * trunk_frames_executed,
        "pool_and_embed": pool,
        "chunks": n_chunks,
        "chunks_executed": executed,
        "fbank_frames": fbank_frames,
        "trunk_frames_executed": trunk_frames_executed,
    }


def total_flops(stages: Dict[str, int]) -> int:
    """The sum of ``diarization_device_flops``' five FLOP stages."""
    return sum(v for k, v in stages.items()
               if k in ("sinc_whole_conv", "segmentation", "fbank",
                        "trunk", "pool_and_embed"))


def diarization_resident_hbm_bytes(
        file_seconds: float,
        sample_rate: int = 16000,
        window: float = 10.0,
        step: float = 1.0,
        trunk_stride: int = 8,
        fixed_bytes: int = 192 * 1024 * 1024,
) -> Dict[str, int]:
    """Named whole-file device buffers of one file on the accelerator path
    (shared sinc front-end, whole-file fbank and trunk panels), plus a
    fixed term for the parameters and one 256-chunk working batch.

    Per-kernel scratch is not modelled: the number is the floor that the
    whole-file design pins, which is what bounds the longest file taken
    whole. The waveform terms are the JAX package's upload (float32 plus
    the int16 buffer of its quantized transport); the port's own whole-
    file waveform costs about the same (a float32 upload and its
    grid-padded copy).
    """
    n = int(file_seconds * sample_rate)
    win = int(window * sample_rate)
    hop = int(step * sample_rate)
    num_full = 1 + (n - win) // hop if n >= win else 0
    has_last = (n < win) or ((n - win) % hop > 0)
    n_chunks = num_full + int(has_last)
    needed = (n_chunks - 1) * hop + win
    bucket = 30 * sample_rate
    padded = max(needed, -(-needed // bucket) * bucket)

    sinc_frames = conv1d_out(padded, SINC_KERNEL, 10)
    fbank_frames = conv1d_out(padded, 400, 160)
    trunk_frames = -(-fbank_frames // trunk_stride)
    terms = {
        "waveform_f32": padded * 4,
        "waveform_int16": padded * 2,
        # shared sinc conv features, 80 filters f32 at stride 10
        "sinc_features": sinc_frames * SINC_FILTERS * 4,
        # whole-file log-mel fbank, 80 bins f32
        "fbank": fbank_frames * 80 * 4,
        # whole-file ResNet trunk: 256 channels x 10 freq = 2560 f32
        "trunk_panels": trunk_frames * 2560 * 4,
        # parameters + one 256-chunk gathered batch (256 x 10 s x f32)
        "fixed": fixed_bytes + 256 * win * 4,
    }
    terms["total"] = sum(terms.values())
    return terms
