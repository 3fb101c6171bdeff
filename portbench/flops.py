"""The benchmark's own operation and byte counts, and the card's peaks.

The FLOP arithmetic is that of the port's ``utils/flops.py`` (1 MAC = 2
FLOPs; elementwise, normalisation and pooling reductions left out), but
it counts the work the audio needs, not what an implementation executes:
the real chunks of a recording (no padded batches), the sinc conv and the
fbank over the recording's chunk grid, the embedding trunk over the
recording's own fbank frames once (no panels, no halos), and the pooling
and projection once per real (chunk, local speaker). So a count follows
the audio and the published widths only, and a share of the peak taken
from it cannot pass 100 %. A configuration module's ``recording_flops``
sums a recording's stages from these functions (``diarization.py`` for
the diarization configurations); a segmentation kind's reference module
(``portbench/reference/<kind>.py``) gives the FLOPs and LSTM steps of its
chunk (``chunk_flops``) and of what it runs once over a recording
(``shared_flops``).

``lstm_bound`` is the least time of one LSTM recurrence launch (a copy of
``chip_smoke.py``'s): bytes (xw read, out written, W_hh read, once each)
over the HBM bandwidth, against the recurrent product's operations over
the tensor cores' rate in the precision's mode.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAK = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def conv1d_out(n: int, kernel: int, stride: int = 1) -> int:
    return (n - kernel) // stride + 1 if n >= kernel else 0


def conv1d_flops(frames_out: int, kernel: int, cin: int, cout: int,
                 groups: int = 1) -> int:
    return 2 * kernel * (cin // groups) * cout * frames_out


def lstm_flops(steps: int, input_sizes: Sequence[int], hidden: int) -> int:
    """Bidirectional gate products, 4H x (I + H) per step, direction and
    layer."""
    return 2 * 2 * steps * sum(4 * hidden * (i + hidden)
                               for i in input_sizes)


def chunk_grid(num_samples: int, window: int, step: int) -> Tuple[int, int]:
    """(chunks, grid-padded samples) of a recording."""
    full = 1 + (num_samples - window) // step if num_samples >= window else 0
    last = num_samples < window or (num_samples - window) % step > 0
    chunks = full + int(last)
    return chunks, (chunks - 1) * step + window


def pyannet_chunk_flops(window: int, stride: int, hidden: int, layers: int,
                        linear: int, linear_layers: int, classes: int
                        ) -> Tuple[int, int]:
    """(FLOPs after the shared sinc conv, LSTM steps) of one chunk."""
    f = conv1d_out(window, 251, stride) // 3
    convs = conv1d_flops(conv1d_out(f, 5), 5, 80, 60)
    f = conv1d_out(f, 5) // 3
    convs += conv1d_flops(conv1d_out(f, 5), 5, 60, 60)
    f = conv1d_out(f, 5) // 3
    lstm = lstm_flops(f, [60] + [2 * hidden] * (layers - 1), hidden)
    widths = [2 * hidden] + [linear] * linear_layers + [classes]
    head = 2 * f * sum(a * b for a, b in zip(widths, widths[1:]))
    return convs + lstm + head, f


def wavlm_chunk_flops(window: int, hp: dict) -> Tuple[int, int]:
    """(FLOPs, frames) of one chunk through a WavLM / wav2vec 2.0 trunk:
    the conv feature extractor, the projection, the grouped positional
    conv and the transformer layers (projections, attention products,
    feed-forward)."""
    n, cin, flops = window, 1, 0
    for cout, kernel, stride in hp["conv_layers"]:
        n = conv1d_out(n, kernel, stride)
        flops += conv1d_flops(n, kernel, cin, cout)
        cin = cout
    d, ffn = hp["hidden"], hp["ffn"]
    flops += 2 * cin * d * n
    flops += conv1d_flops(n, hp["pos_conv_kernel"], d, d,
                          hp["pos_conv_groups"])
    per_layer = 2 * 4 * d * d * n + 2 * 2 * n * n * d + 2 * 2 * d * ffn * n
    return flops + hp["layers"] * per_layer, n


def resnet_trunk_flops_per_frame(m: int, num_blocks: Sequence[int],
                                 freq: int) -> int:
    """FLOPs of the BasicBlock ResNet trunk per input fbank frame."""
    total = 2 * 9 * 1 * m * freq
    cin, t_scale, w = m, 1.0, freq
    for blocks, mult, stride in zip(num_blocks, (1, 2, 4, 8), (1, 2, 2, 2)):
        mid = m * mult
        for b in range(blocks):
            s = stride if b == 0 else 1
            t_scale /= s
            w = -(-w // s)
            area = t_scale * w
            total += area * (2 * 9 * cin * mid + 2 * 9 * mid * mid)
            if s != 1 or cin != mid:
                total += area * 2 * cin * mid
            cin = mid
    return int(total)


def fbank_flops(frames: int, window: int = 400, fft: int = 512,
                mel: int = 80) -> int:
    bins = fft // 2 + 1
    return conv1d_flops(frames, window, 1, 2 * bins) + 2 * frames * bins * mel


def chunk_flops(spec: dict, window: int, classes: int) -> Tuple[int, int]:
    """(FLOPs, LSTM steps) of one chunk through the segmentation model
    ``spec``, from its kind's reference module
    (``portbench/reference/<kind>.py``)."""
    from portbench.reference.segmentation_models import model
    return model(spec).chunk_flops(spec, window, classes)


def shared_flops(spec: dict, padded: int) -> Dict[str, int]:
    """FLOPs by stage of what the segmentation model ``spec`` runs once
    over a recording grid-padded to ``padded`` samples, not per chunk."""
    from portbench.reference.segmentation_models import model
    return model(spec).shared_flops(spec, padded)


def lstm_bound(T: int, B: int, H: int, D: int, precision: str) -> float:
    """Least seconds of one recurrence launch on an H100 SXM at 700 W."""
    weight_bytes = 2 if precision == "default" else 4
    moved = 4 * T * B * D * 4 * H + 4 * T * B * D * H \
        + D * 4 * H * H * weight_bytes
    product = 2 * T * B * D * 4 * H * H
    flops = product * (3 if precision == "high" else 1)
    rate = PEAK["fp32_flops"] if precision == "highest" \
        else PEAK["bf16_flops"]
    return max(moved / PEAK["hbm_bytes"], flops / rate)
