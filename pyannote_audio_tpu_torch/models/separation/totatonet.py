"""ToTaToNet: joint speech separation and diarization (PixIT).

Counterpart of pyannote_audio_tpu/models/separation/totatonet.py: a free
conv encoder (64 filters, kernel 32, stride 16), optionally WavLM's last
state repeat-upsampled to the encoder's frame rate (``320 // stride``)
and padded or cropped to its frames, a DPRNN masker, the masked
representation decoded per source by a transposed conv (cut or padded to
the input length), and a diarization branch: the masked representation
average-pooled by ``diarization_scaling`` frames, leaky-ReLU linears and
a sigmoid per source.

Submodules carry the reference's names: asteroid's
``encoder.filterbank._filters`` (n_filters, 1, kernel) and
``decoder.filterbank._filters`` in ``conv_transpose1d``'s (in, out,
kernel) layout, used as they are (the JAX module flips its decoder
kernel instead), the DPRNN's ``masker.*``, ``linear.{i}``, ``classifier``
and HF's names under ``wavlm.*``. A checkpoint with ``wavlm.*`` keys
builds the WavLM branch from them (``load_reference_state_dict``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.model import FrameModel, Problem, Specifications
from ...utils.receptive_field import (conv1d_num_frames,
                                      conv1d_receptive_field_center,
                                      conv1d_receptive_field_size)
from ...utils.runtime import exact_float32
from ..blocks.dprnn import DPRNN
from ..blocks.ssl import (SSLEncoder, hf_layout, infer_ssl_config,
                          init_linear, load_torch_ssl_state, uniform_)

ENCODER_DECODER_DEFAULTS = {"fb_name": "free", "kernel_size": 32,
                            "n_filters": 64, "stride": 16}
LINEAR_DEFAULTS = {"hidden_size": 64, "num_layers": 2}
DPRNN_DEFAULTS = {"n_repeats": 6, "bn_chan": 128, "hid_size": 128,
                  "chunk_size": 100, "norm_type": "gLN", "mask_act": "relu",
                  "rnn_type": "LSTM"}
DIAR_DEFAULTS = {"frames_per_second": 125}
# WavLM's frame stride in samples
SSL_STRIDE = 320


def default_specifications(n_sources: int = 3, duration: float = 5.0
                           ) -> Tuple[Specifications, Specifications]:
    """Multi-label diarization per source, then regression of the
    sources; both permutation-invariant."""
    return (Specifications(duration=duration,
                           classes=[f"speaker#{i + 1}"
                                    for i in range(n_sources)],
                           problem=Problem.MULTI_LABEL_CLASSIFICATION,
                           permutation_invariant=True),
            Specifications(duration=duration,
                           classes=[f"source#{i + 1}"
                                    for i in range(n_sources)],
                           problem=Problem.REGRESSION,
                           permutation_invariant=True))


class _Filterbank(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self._filters = nn.Parameter(torch.empty(n_filters, 1, kernel_size))
        uniform_(self._filters, kernel_size ** -0.5, generator)


class _FilterbankHolder(nn.Module):
    """asteroid's Encoder / Decoder: only the ``filterbank`` they hold."""

    def __init__(self, n_filters: int, kernel_size: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.filterbank = _Filterbank(n_filters, kernel_size, generator)


class ToTaToNet(FrameModel, nn.Module):
    """(B, 1, samples) -> (diarization (B, frames, n_sources) in [0, 1],
    sources (B, samples, n_sources)).

    ``use_wavlm`` is False, True with a ``wavlm_config`` (an SSL config
    dict, e.g. ``models.segmentation.sseriouss.SSL_CONFIGS
    ["WAVLM_LARGE"]``; weights seeded or loaded later), or a local torch
    WavLM checkpoint (its weights are loaded). There is no hub download.
    """

    def __init__(self, encoder_decoder: Optional[Mapping] = None,
                 linear: Optional[Mapping] = None,
                 diar: Optional[Mapping] = None,
                 dprnn: Optional[Mapping] = None, sample_rate: int = 16000,
                 n_sources: int = 3,
                 use_wavlm: Union[bool, str, Path] = False,
                 wavlm_frozen: bool = False,
                 wavlm_config: Optional[Mapping] = None,
                 specifications=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_sources = n_sources
        self.encoder_decoder = {**ENCODER_DECODER_DEFAULTS,
                                **(encoder_decoder or {})}
        self.linear_hparams = {**LINEAR_DEFAULTS, **(linear or {})}
        self.dprnn = {**DPRNN_DEFAULTS, **(dprnn or {})}
        self.diar = {**DIAR_DEFAULTS, **(diar or {})}
        self.wavlm_frozen = wavlm_frozen
        self.specifications = specifications or \
            default_specifications(n_sources)
        ed = self.encoder_decoder
        self.diarization_scaling = int(
            sample_rate / self.diar["frames_per_second"] / ed["stride"])
        wavlm_state = None
        if use_wavlm is True and wavlm_config is None:
            raise NotImplementedError(
                "the WavLM branch needs a wavlm_config or a local WavLM "
                "checkpoint (there is no model download): pass "
                "use_wavlm=<path> or wavlm_config=...")
        if use_wavlm and use_wavlm is not True:
            wavlm_state = load_torch_ssl_state(use_wavlm)
            wavlm_config = infer_ssl_config(wavlm_state)
        self.wavlm_config = dict(wavlm_config) if use_wavlm else None
        self.encoder = _FilterbankHolder(ed["n_filters"], ed["kernel_size"],
                                         generator)
        self.decoder = _FilterbankHolder(ed["n_filters"], ed["kernel_size"],
                                         generator)
        self.wavlm = None
        self._build_branch(generator)
        if wavlm_state is not None:
            self.wavlm.load_ssl_state_dict(wavlm_state)
        width = ed["n_filters"]
        self.linear = nn.ModuleList()
        for _ in range(self.linear_hparams["num_layers"]):
            self.linear.append(init_linear(
                nn.Linear(width, self.linear_hparams["hidden_size"]),
                generator))
            width = self.linear_hparams["hidden_size"]
        self.classifier = init_linear(nn.Linear(width, 1), generator)

    def _build_branch(self, generator: Optional[torch.Generator]) -> None:
        """The WavLM encoder (when configured) and the masker, whose input
        width depends on it."""
        c = self.wavlm_config
        if c is not None:
            self.wavlm = SSLEncoder(
                hidden=c["hidden"], layers=c["layers"], heads=c["heads"],
                ffn=c["ffn"], conv_channels=c.get("conv_channels", 512),
                rel_pos_bias=c["rel_pos_bias"], pre_ln=c.get("pre_ln", True),
                conv_norm=c.get("conv_norm", "layer"), generator=generator)
        n_filters = self.encoder_decoder["n_filters"]
        d = self.dprnn
        self.masker = DPRNN(
            in_chan=n_filters + (c["hidden"] if c is not None else 0),
            out_chan=n_filters, n_src=self.n_sources, bn_chan=d["bn_chan"],
            hid_size=d["hid_size"], chunk_size=d["chunk_size"],
            n_repeats=d["n_repeats"], mask_act=d["mask_act"],
            generator=generator)

    @property
    def use_wavlm(self) -> bool:
        return self.wavlm is not None

    @property
    def dimension(self) -> int:
        return 1

    def forward(self, waveforms: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, _, T = waveforms.shape
        stride = self.encoder_decoder["stride"]
        with exact_float32():
            rep = F.conv1d(waveforms, self.encoder.filterbank._filters,
                           stride=stride).transpose(1, 2)     # (B, T', F)
            masker_in = rep
            if self.wavlm is not None:
                w = self.wavlm(waveforms)[-1]                  # (B, Tw, H)
                w = torch.repeat_interleave(w, SSL_STRIDE // stride, dim=1)
                Tp = rep.shape[1]
                w = F.pad(w, (0, 0, 0, Tp - w.shape[1])) \
                    if w.shape[1] < Tp else w[:, :Tp]
                masker_in = torch.cat([rep, w], dim=-1)
            masks = self.masker(masker_in)                  # (B, S, T', F)
            masked = masks * rep[:, None]
            dec_in = masked.reshape(B * self.n_sources, *masked.shape[2:])
            decoded = F.conv_transpose1d(
                dec_in.transpose(1, 2), self.decoder.filterbank._filters,
                stride=stride)[:, 0].reshape(B, self.n_sources, -1)
            pad = T - decoded.shape[-1]
            decoded = F.pad(decoded, (0, pad)) if pad > 0 \
                else decoded[..., :T]
            sources = decoded.transpose(1, 2)              # (B, T, S)

            s = self.diarization_scaling
            Td = dec_in.shape[1] // s
            d = dec_in[:, :Td * s].reshape(dec_in.shape[0], Td, s,
                                           dec_in.shape[2]).mean(dim=2)
            h = d
            for layer in self.linear:
                h = F.leaky_relu(layer(h), 0.01)
            if not len(self.linear):
                h = d.square().sum(dim=-1, keepdim=True)
            scores = self.classifier(h)[..., 0].reshape(B, self.n_sources,
                                                        Td)
            diarization = torch.sigmoid(scores.transpose(1, 2))
        return diarization, sources

    def frozen_mask_prefixes(self) -> List[str]:
        """The parameter prefixes an update mask freezes (for
        ``GraduallyUnfreeze`` and ``Trainer.frozen_prefixes``)."""
        return ["wavlm"] if self.use_wavlm and self.wavlm_frozen else []

    def reference_hparams(self) -> Dict:
        hparams = {"encoder_decoder": dict(self.encoder_decoder),
                   "linear": dict(self.linear_hparams),
                   "dprnn": dict(self.dprnn), "diar": dict(self.diar),
                   "n_sources": self.n_sources,
                   "use_wavlm": self.use_wavlm,
                   "wavlm_frozen": self.wavlm_frozen,
                   "sample_rate": self.sample_rate, "num_channels": 1}
        if self.wavlm_config is not None:
            hparams["wavlm_config"] = dict(self.wavlm_config)
        return hparams

    def load_reference_state_dict(self, state: Mapping) -> "ToTaToNet":
        """Load the reference layout. ``wavlm.*`` keys (a PixIT checkpoint
        embeds its fine-tuned WavLM in HF's layout) build the WavLM branch
        from them when the model has none: its config is read off the
        weights and the masker is rebuilt for the wider input."""
        wavlm = {k[len("wavlm."):]: v for k, v in state.items()
                 if k.startswith("wavlm.")}
        if wavlm and self.wavlm is None:
            self.wavlm_config = infer_ssl_config(wavlm)
            self._build_branch(None)
        tensors = {f"wavlm.{k}": v for k, v in hf_layout(wavlm).items()}
        for key, value in state.items():
            if key.startswith("wavlm."):
                continue
            value = np.asarray(value, dtype=np.float32)
            if key == "masker.first_out.0.weight":
                value = value.reshape(1)
            tensors[key] = torch.from_numpy(value.copy())
        self.load_state_dict(tensors, strict=True)
        return self

    def export_torch_state_dict(self) -> Dict[str, np.ndarray]:
        """The reference layout (what the JAX model's
        ``export_torch_state_dict`` writes): this module's own names."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.state_dict().items()}

    # -- frame math: the diarization frames as one equivalent conv ----------

    def _equivalent_conv(self) -> Dict[str, int]:
        s = self.diarization_scaling
        return {"kernel_size": s * self.encoder_decoder["kernel_size"],
                "stride": s * self.encoder_decoder["stride"]}

    def num_frames(self, num_samples: int) -> int:
        return conv1d_num_frames(num_samples, **self._equivalent_conv())

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return conv1d_receptive_field_size(num_frames,
                                           **self._equivalent_conv())

    def receptive_field_center(self, frame: int = 0) -> int:
        return conv1d_receptive_field_center(frame,
                                             **self._equivalent_conv())
