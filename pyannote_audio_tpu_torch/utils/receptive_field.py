"""Receptive-field arithmetic for stacks of 1-d convolutions/poolings.

Counterpart of pyannote_audio_tpu/utils/receptive_field.py: pure integer
math behind every model's frame alignment.
"""

from __future__ import annotations

from typing import Sequence


def conv1d_num_frames(num_samples: int, kernel_size: int = 5, stride: int = 1,
                      padding: int = 0, dilation: int = 1) -> int:
    """Output length of a 1-d convolution (floor formula)."""
    return 1 + (num_samples + 2 * padding - dilation * (kernel_size - 1) - 1) \
        // stride


def conv1d_receptive_field_size(num_frames: int = 1, kernel_size: int = 5,
                                stride: int = 1, dilation: int = 1) -> int:
    """Input span covered by ``num_frames`` consecutive outputs of one 1-d
    convolution."""
    return 1 + (kernel_size - 1) * dilation + (num_frames - 1) * stride


def conv1d_receptive_field_center(frame: int = 0, kernel_size: int = 5,
                                  stride: int = 1, padding: int = 0,
                                  dilation: int = 1) -> int:
    """Index of the input sample at the center of one 1-d convolution's
    output frame."""
    return frame * stride - padding + (kernel_size - 1) * dilation // 2


def multi_conv_num_frames(num_samples: int, kernel_size: Sequence[int],
                          stride: Sequence[int], padding: Sequence[int],
                          dilation: Sequence[int]) -> int:
    n = num_samples
    for k, s, p, d in zip(kernel_size, stride, padding, dilation):
        n = conv1d_num_frames(n, kernel_size=k, stride=s, padding=p,
                              dilation=d)
    return n


def multi_conv_receptive_field_size(num_frames: int,
                                    kernel_size: Sequence[int],
                                    stride: Sequence[int],
                                    dilation: Sequence[int]) -> int:
    """Input span covered by ``num_frames`` consecutive outputs."""
    size = num_frames
    for k, s, d in reversed(list(zip(kernel_size, stride, dilation))):
        size = conv1d_receptive_field_size(size, k, s, d)
    return size


def multi_conv_receptive_field_center(frame: int, kernel_size: Sequence[int],
                                      stride: Sequence[int],
                                      padding: Sequence[int],
                                      dilation: Sequence[int]) -> int:
    """Index of the input sample at the center of a frame's field."""
    center = frame
    for k, s, p, d in reversed(list(zip(kernel_size, stride, padding,
                                        dilation))):
        center = conv1d_receptive_field_center(center, k, s, p, d)
    return center
