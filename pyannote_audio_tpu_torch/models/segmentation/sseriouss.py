"""SSeRiouSS: wav2vec2 / WavLM trunk -> BiLSTM -> feed-forward -> classifier.

Counterpart of pyannote_audio_tpu/models/segmentation/sseriouss.py. The
trunk is ``models.blocks.ssl.SSLEncoder`` (raw layer outputs, as
torchaudio's ``extract_features`` gives them); ``wav2vec_layer < 0``
averages the transformer layers' outputs with softmax weights
(``wav2vec_weights``), ``wav2vec_layer = k`` takes the output of layer
k - 1 (state k; state 0 is the embedding). The head is the port's LSTM
(the CUDA kernel on the card), leaky-ReLU linears and a log-softmax or
sigmoid classifier, all float32 with TF32 off.

The reference checkpoint layout (``convert_torch_state_dict`` /
``export_torch_state_dict`` of the JAX model) stores the trunk under
``wav2vec.*`` in torchaudio's nesting; the module itself carries HF names
there, and ``load_reference_state_dict`` / ``export_torch_state_dict``
fold one onto the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.model import FrameModel, Problem, Specifications
from ...utils.runtime import exact_float32
from ..blocks.rnn import LSTM
from ..blocks.ssl import (SSLEncoder, hf_layout, infer_ssl_config,
                          init_linear, load_torch_ssl_state,
                          torchaudio_layout)

# torchaudio-bundle names the reference accepts: BASE models are post-LN
# with a group-norm conv trunk, WavLM-large pre-LN with a layer-norm one
SSL_CONFIGS = {
    "WAV2VEC2_BASE": dict(hidden=768, layers=12, heads=12, ffn=3072,
                          rel_pos_bias=False, pre_ln=False,
                          conv_norm="group"),
    "WAV2VEC2_LARGE": dict(hidden=1024, layers=24, heads=16, ffn=4096,
                           rel_pos_bias=False, pre_ln=False,
                           conv_norm="group"),
    "WAVLM_BASE": dict(hidden=768, layers=12, heads=12, ffn=3072,
                       rel_pos_bias=True, pre_ln=False, conv_norm="group"),
    "WAVLM_BASE_PLUS": dict(hidden=768, layers=12, heads=12, ffn=3072,
                            rel_pos_bias=True, pre_ln=False,
                            conv_norm="group"),
    "WAVLM_LARGE": dict(hidden=1024, layers=24, heads=16, ffn=4096,
                        rel_pos_bias=True, pre_ln=True, conv_norm="layer"),
}

LSTM_DEFAULTS = {"hidden_size": 128, "num_layers": 4, "bidirectional": True,
                 "monolithic": True, "dropout": 0.0}
LINEAR_DEFAULTS = {"hidden_size": 128, "num_layers": 2}


def ssl_config(wav2vec: Union[str, Mapping, None]) -> Dict:
    """The encoder config a ``wav2vec`` hyper-parameter names: a bundle
    name, a torchaudio ``wav2vec2_model`` kwargs dict (what reference
    checkpoints persist), or a config dict (hidden, layers, heads, ffn,
    ...). A local checkpoint path is read by ``SSeRiouSS`` itself."""
    if wav2vec is None:
        wav2vec = "WAVLM_BASE"
    if isinstance(wav2vec, str):
        if wav2vec not in SSL_CONFIGS:
            raise ValueError(f"unknown SSL bundle {wav2vec!r}; choose from "
                             f"{sorted(SSL_CONFIGS)} or pass a local torch "
                             f"wav2vec2/WavLM checkpoint path")
        return dict(SSL_CONFIGS[wav2vec])
    if "encoder_embed_dim" in wav2vec:
        conv = wav2vec.get("extractor_conv_layer_config") or []
        return dict(hidden=wav2vec["encoder_embed_dim"],
                    layers=wav2vec["encoder_num_layers"],
                    heads=wav2vec["encoder_num_heads"],
                    ffn=wav2vec["encoder_ff_interm_features"],
                    conv_channels=conv[0][0] if conv else 512,
                    rel_pos_bias="encoder_num_buckets" in wav2vec,
                    pre_ln=wav2vec.get("encoder_layer_norm_first", False),
                    conv_norm="layer"
                    if wav2vec.get("extractor_mode") == "layer_norm"
                    else "group")
    return dict(wav2vec)


class SSeRiouSS(FrameModel, nn.Module):
    """(B, 1, samples) -> (B, frames, dimension) scores.

    ``wav2vec`` is a bundle name (default WAVLM_BASE), a local torch
    wav2vec2 / WavLM checkpoint (its weights are loaded), torchaudio
    kwargs or a config dict. ``specifications`` defaults to PyanNet's
    diarization setting (10 s, 3 speakers, at most 2 at once: a 7-class
    powerset).
    """

    def __init__(self, specifications: Optional[Specifications] = None,
                 wav2vec: Union[str, Mapping, None] = None,
                 wav2vec_layer: int = -1, freeze_wav2vec: bool = False,
                 lstm: Optional[Mapping] = None,
                 linear: Optional[Mapping] = None,
                 sample_rate: int = 16000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specifications = specifications or Specifications(
            duration=10.0, classes=["speaker#1", "speaker#2", "speaker#3"],
            powerset_max_classes=2)
        self.sample_rate = sample_rate
        ssl_state = None
        if isinstance(wav2vec, (str, Path)) and \
                str(wav2vec) not in SSL_CONFIGS and Path(wav2vec).exists():
            ssl_state = load_torch_ssl_state(wav2vec)
            config = infer_ssl_config(ssl_state)
            wav2vec = str(wav2vec)
        else:
            config = ssl_config(wav2vec)
        self.wav2vec_name = wav2vec if wav2vec is not None else "WAVLM_BASE"
        self.ssl_config = config
        self.wav2vec_layer = wav2vec_layer
        self.freeze_wav2vec = freeze_wav2vec
        self.lstm_hparams = {**LSTM_DEFAULTS, **(lstm or {})}
        self.linear_hparams = {**LINEAR_DEFAULTS, **(linear or {})}
        self.wav2vec = SSLEncoder(
            hidden=config["hidden"], layers=config["layers"],
            heads=config["heads"], ffn=config["ffn"],
            conv_channels=config.get("conv_channels", 512),
            rel_pos_bias=config["rel_pos_bias"],
            pre_ln=config.get("pre_ln", False),
            conv_norm=config.get("conv_norm", "group"),
            normalize_last=False, generator=generator)
        if ssl_state is not None:
            self.wav2vec.load_ssl_state_dict(ssl_state)
        if wav2vec_layer < 0:
            self.wav2vec_weights = nn.Parameter(torch.ones(config["layers"]))
        lstm_h = self.lstm_hparams
        self.lstm = LSTM(config["hidden"], hidden_size=lstm_h["hidden_size"],
                         num_layers=lstm_h["num_layers"],
                         bidirectional=lstm_h["bidirectional"],
                         generator=generator)
        width = lstm_h["hidden_size"] * (2 if lstm_h["bidirectional"] else 1)
        self.linear = nn.ModuleList()
        for _ in range(self.linear_hparams["num_layers"]):
            self.linear.append(init_linear(
                nn.Linear(width, self.linear_hparams["hidden_size"]),
                generator))
            width = self.linear_hparams["hidden_size"]
        self.classifier = init_linear(
            nn.Linear(width, self.specifications.dimension), generator)

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        states = self.wav2vec(waveforms)
        with exact_float32():
            if self.wav2vec_layer < 0:
                w = torch.softmax(self.wav2vec_weights, dim=0)
                x = w[0] * states[1]
                for wi, si in zip(w[1:], states[2:]):
                    x = x + wi * si
            else:
                x = states[self.wav2vec_layer]
            x = self.lstm(x)
            for layer in self.linear:
                x = F.leaky_relu(layer(x), 0.01)
            x = self.classifier(x)
            if self.specifications.problem == \
                    Problem.MONO_LABEL_CLASSIFICATION:
                return F.log_softmax(x, dim=-1)
            return torch.sigmoid(x)

    def frozen_mask_prefixes(self) -> List[str]:
        """The parameter prefixes an update mask freezes (for
        ``GraduallyUnfreeze`` and ``Trainer.frozen_prefixes``)."""
        return ["wav2vec"] if self.freeze_wav2vec else []

    def reference_hparams(self) -> Dict:
        return {"wav2vec": self.wav2vec_name,
                "wav2vec_layer": self.wav2vec_layer,
                "freeze_wav2vec": self.freeze_wav2vec,
                "lstm": dict(self.lstm_hparams),
                "linear": dict(self.linear_hparams),
                "sample_rate": self.sample_rate, "num_channels": 1}

    def load_reference_state_dict(self, state: Mapping) -> "SSeRiouSS":
        """Load the reference layout: ``wav2vec.*`` in torchaudio's (or
        HF's) nesting, ``wav2vec_weights``, the monolithic or per-layer
        ``lstm.*``, ``linear.{i}.*`` and ``classifier.*``."""
        tensors = {f"wav2vec.{k}": v for k, v in hf_layout(
            {k[len("wav2vec."):]: v for k, v in state.items()
             if k.startswith("wav2vec.")}).items()}
        for key, value in state.items():
            if key.startswith("wav2vec."):
                continue
            parts = key.split(".")
            if parts[0] == "lstm" and len(parts) == 3 and parts[1].isdigit():
                key = "lstm." + parts[2].replace("_l0", f"_l{parts[1]}", 1)
            if key == "wav2vec_weights":
                value = np.asarray(value, dtype=np.float32).reshape(-1)
            tensors[key] = torch.from_numpy(np.array(value,
                                                      dtype=np.float32))
        self.load_state_dict(tensors, strict=True)
        return self

    def export_torch_state_dict(self) -> Dict[str, np.ndarray]:
        """The reference layout, as the JAX model's
        ``export_torch_state_dict`` writes it: the trunk in torchaudio's
        nesting under ``wav2vec.*``."""
        state = {k: v.detach().cpu().numpy()
                 for k, v in self.state_dict().items()}
        trunk = torchaudio_layout({k[len("wav2vec."):]: v
                                   for k, v in state.items()
                                   if k.startswith("wav2vec.")})
        out = {f"wav2vec.{k}": v for k, v in trunk.items()}
        out.update({k: v for k, v in state.items()
                    if not k.startswith("wav2vec.")})
        return out

    # -- frame math ---------------------------------------------------------

    def num_frames(self, num_samples: int) -> int:
        return SSLEncoder.num_frames(num_samples)

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return SSLEncoder.receptive_field_size(num_frames)

    def receptive_field_center(self, frame: int = 0) -> int:
        return SSLEncoder.receptive_field_center(frame)
