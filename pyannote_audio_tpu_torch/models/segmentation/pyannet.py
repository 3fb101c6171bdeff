"""PyanNet: SincNet -> BiLSTM -> feed-forward -> classifier.

Counterpart of pyannote_audio_tpu/models/segmentation/pyannet.py
(``PyanNetModule`` and ``PyanNet``'s frame math). Parameter names follow
the reference checkpoint layout (``sincnet.*``, ``lstm.weight_ih_l0``,
``linear.{i}.*``, ``classifier.*``), which is what the JAX model's
``export_torch_state_dict`` emits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.model import FrameModel, Problem, Specifications
from ...utils.runtime import exact_float32
from ..blocks.rnn import LSTM
from ..blocks.sincnet import SincNet


def _linear(in_features: int, out_features: int,
            generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    bound = in_features ** -0.5
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
    return layer


class PyanNet(FrameModel, nn.Module):
    """(B, 1, samples) -> (B, frames, dimension) scores.

    ``specifications`` fixes the chunk duration and the output classes;
    the default is the diarization setting: 10 s chunks, 3 speakers with
    at most 2 active, i.e. a 7-class powerset log-softmax. A mono-label
    problem ends in a log-softmax, any other (multi-label, binary) in a
    sigmoid, as the JAX model's activation follows its problem.
    """

    def __init__(self, specifications: Optional[Specifications] = None,
                 sincnet_stride: int = 10, sample_rate: int = 16000,
                 lstm_hidden: int = 128, lstm_layers: int = 2,
                 bidirectional: bool = True, linear_hidden: int = 128,
                 linear_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specifications = specifications or Specifications(
            duration=10.0, classes=["speaker#1", "speaker#2", "speaker#3"],
            powerset_max_classes=2)
        self.sample_rate = sample_rate
        self.sincnet_stride = sincnet_stride
        self.sincnet = SincNet(stride=sincnet_stride,
                               sample_rate=sample_rate, generator=generator)
        self.lstm = LSTM(60, hidden_size=lstm_hidden, num_layers=lstm_layers,
                         bidirectional=bidirectional, generator=generator)
        width = lstm_hidden * (2 if bidirectional else 1)
        self.linear = nn.ModuleList()
        for _ in range(linear_layers):
            self.linear.append(_linear(width, linear_hidden, generator))
            width = linear_hidden
        self.classifier = _linear(width, self.specifications.dimension,
                                  generator)

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        return self._head(self.sincnet(waveforms))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """(B, frames, 60) float32 SincNet features -> model output, all
        float32 with TF32 off (``utils.runtime.exact_float32``)."""
        with exact_float32():
            x = self.lstm(x)
            for layer in self.linear:
                x = F.leaky_relu(layer(x), 0.01)
            x = self.classifier(x)
            if self.specifications.problem == \
                    Problem.MONO_LABEL_CLASSIFICATION:
                return F.log_softmax(x, dim=-1)
            return torch.sigmoid(x)

    # -- shared front-end protocol (read by Inference.slide) ----------------

    # Inference.slide may run the sinc conv once per file and gather each
    # chunk's frames (SincNet.from_conv) instead of convolving every
    # overlapping chunk again.
    FRONTEND_SHARED = True

    @property
    def frontend_stride(self) -> int:
        return self.sincnet_stride

    def frontend_num_frames(self, window_samples: int) -> int:
        """Sinc-conv output frames of one chunk."""
        return SincNet.conv_num_frames(window_samples, self.sincnet_stride)

    def precompute_frontend(self, waveform: torch.Tensor) -> torch.Tensor:
        """Whole-file raw sinc conv: (1, T) -> (1, 80, F_all)."""
        return self.sincnet.whole_conv(waveform[:, None, :])

    def forward_from_frontend(self, frames: torch.Tensor, mean: torch.Tensor,
                              var: torch.Tensor) -> torch.Tensor:
        """Forward from gathered conv frames (B, 80, F_c) and each chunk's
        raw-waveform mean and population variance (B,)."""
        return self._head(self.sincnet.from_conv(frames, mean, var))

    def reference_hparams(self) -> Dict:
        """Hyper-parameters in the reference checkpoint layout (what
        ``utils.convert.write_reference_checkpoint`` stores and
        ``core.model.Model.from_pretrained`` reads back)."""
        return {"sincnet": {"stride": self.sincnet_stride},
                "lstm": {"hidden_size": self.lstm.hidden_size,
                         "num_layers": self.lstm.num_layers,
                         "bidirectional": self.lstm.bidirectional,
                         "monolithic": True, "dropout": 0.0},
                "linear": {"hidden_size": self.linear[0].out_features
                           if len(self.linear) else 0,
                           "num_layers": len(self.linear)},
                "sample_rate": self.sample_rate, "num_channels": 1}

    def load_reference_state_dict(self, state: Mapping[str, np.ndarray]):
        """Load a reference-layout state dict (numpy arrays or tensors).

        Accepts the monolithic ``lstm.weight_ih_l{i}[_reverse]`` keys and
        the per-layer ``lstm.{i}.weight_ih_l0[_reverse]`` layout of
        ``lstm["monolithic"] = False``, which is the same math at inference.
        """
        tensors: Dict[str, torch.Tensor] = {}
        for key, value in state.items():
            parts = key.split(".")
            if parts[0] == "lstm" and len(parts) == 3 and \
                    parts[1].isdigit():
                # lstm.{i}.weight_ih_l0[_reverse] -> lstm.weight_ih_l{i}...
                i, name = parts[1], parts[2]
                key = "lstm." + name.replace("_l0", f"_l{i}", 1)
            tensors[key] = torch.tensor(np.asarray(value, dtype=np.float32))
        self.load_state_dict(tensors, strict=True)
        return self

    # -- frame math ---------------------------------------------------------

    def num_frames(self, num_samples: int) -> int:
        return SincNet.num_frames(num_samples, stride=self.sincnet_stride)

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return SincNet.receptive_field_size(num_frames,
                                            stride=self.sincnet_stride)

    def receptive_field_center(self, frame: int = 0) -> int:
        return SincNet.receptive_field_center(frame,
                                              stride=self.sincnet_stride)
