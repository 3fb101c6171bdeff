"""TitaNet (NeMo's speaker embedding), loaded from a ``.nemo`` archive.

Counterpart of pyannote_audio_tpu/models/embedding/titanet.py, at
nvidia/speakerverification_en_titanet_large's layout by default
(``TITANET_LARGE_BLOCKS``):

- NeMo's mel front-end (ops/fbank.py ``nemo_mel_spectrogram``);
- ConvASREncoder: stride-1 Jasper blocks of time-masked 1-d convs
  (depthwise-separable where configured), BatchNorm, ReLU between
  repeats, a global squeeze-excitation (reduction 8), the 1x1-conv + BN
  residual of the block input added before the final ReLU;
- SpeakerDecoder: attentive stats pooling over [x, mean, std], then a
  BatchNorm and a 1x1 conv to the 192-d embedding (the classification
  head is training-only and dropped).

Masks are (batch, frames) and binary: every conv's input is zeroed
outside them, the SE and pooling statistics count only their frames, and
the attention softmax is masked with -inf. BatchNorm uses running
statistics (eval mode); everything runs in float32 under
``utils.runtime.exact_float32``.

``convert_nemo_state_dict`` maps a NeMo ``EncDecSpeakerLabelModel``
state dict onto the module (the ``mconv`` indices are parsed, so repeat
counts and separability of each TitaNet size map), and
``export_nemo_state_dict`` / ``export_nemo_checkpoint`` write one
(``_mconv_layout`` gives NeMo's indices). ``from_nemo`` reads a local
``.nemo`` tar or an extracted directory; ``yaml`` is imported only where
``model_config.yaml`` is read or written, and there is no hub access.
"""

from __future__ import annotations

import io
import re
import tarfile
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fbank import nemo_mel_num_frames, nemo_mel_spectrogram
from ...utils.runtime import exact_float32
from ...utils.signal import nearest_binary_mask

# titanet_large.yaml's encoder (filters 1024): a prologue block, three
# repeated separable blocks (k = 7 / 11 / 15) with residuals, a kernel-1
# epilogue at 3072 channels, all with global SE
TITANET_LARGE_BLOCKS = [
    dict(filters=1024, repeat=1, kernel=3, residual=False,
         separable=True, se=True),
    dict(filters=1024, repeat=3, kernel=7, residual=True,
         separable=True, se=True),
    dict(filters=1024, repeat=3, kernel=11, residual=True,
         separable=True, se=True),
    dict(filters=1024, repeat=3, kernel=15, residual=True,
         separable=True, se=True),
    dict(filters=3072, repeat=1, kernel=1, residual=False,
         separable=False, se=True),
]


def _init_(module: nn.Module, fan_in: int,
           generator: Optional[torch.Generator]) -> nn.Module:
    """Uniform +-fan_in^-1/2 weights (and bias), seeded."""
    bound = fan_in ** -0.5
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
    return module


def _conv(cin: int, cout: int, kernel: int, dilation: int = 1,
          groups: int = 1, bias: bool = False, generator=None) -> nn.Conv1d:
    return _init_(nn.Conv1d(cin, cout, kernel, dilation=dilation,
                            padding=dilation * (kernel - 1) // 2,
                            groups=groups, bias=bias),
                  cin // groups * kernel, generator)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """(B, C, T) -> (B, C) mean over the mask's frames (at least one)."""
    if mask is None:
        return x.mean(dim=2)
    return (x * mask).sum(dim=2) / torch.clamp(mask.sum(dim=2), min=1.0)


class _SqueezeExcite(nn.Module):
    """Masked global average -> Linear(C, C/8) -> ReLU -> Linear -> sigmoid
    gate."""

    def __init__(self, channels: int, reduction: int = 8, generator=None):
        super().__init__()
        self.fc1 = _init_(nn.Linear(channels, channels // reduction),
                          channels, generator)
        self.fc2 = _init_(nn.Linear(channels // reduction, channels),
                          channels // reduction, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        y = self.fc2(F.relu(self.fc1(_masked_mean(x, mask))))
        return x * torch.sigmoid(y)[:, :, None]


class _JasperBlock(nn.Module):
    """``repeat`` x [masked (separable) conv -> BN (-> ReLU between
    repeats)], SE, the residual of the block input, the final ReLU."""

    def __init__(self, in_channels: int, filters: int, repeat: int = 1,
                 kernel: int = 3, dilation: int = 1, residual: bool = False,
                 separable: bool = False, se: bool = True, generator=None):
        super().__init__()
        self.separable = separable
        self.dw = nn.ModuleList()
        self.pw = nn.ModuleList()
        self.conv = nn.ModuleList()
        self.bn = nn.ModuleList()
        cin = in_channels
        for _ in range(repeat):
            if separable:
                self.dw.append(_conv(cin, cin, kernel, dilation, groups=cin,
                                     generator=generator))
                self.pw.append(_conv(cin, filters, 1, generator=generator))
            else:
                self.conv.append(_conv(cin, filters, kernel, dilation,
                                       generator=generator))
            self.bn.append(nn.BatchNorm1d(filters))
            cin = filters
        self.se = _SqueezeExcite(filters, generator=generator) if se \
            else None
        self.res_conv = _conv(in_channels, filters, 1, generator=generator) \
            if residual else None
        self.res_bn = nn.BatchNorm1d(filters) if residual else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        out = x
        for r, bn in enumerate(self.bn):
            if mask is not None:
                out = out * mask          # MaskedConv1d zero-fills
            out = self.pw[r](self.dw[r](out)) if self.separable \
                else self.conv[r](out)
            out = bn(out)
            if r != len(self.bn) - 1:
                out = F.relu(out)
        if self.se is not None:
            out = self.se(out, mask)
        if self.res_conv is not None:
            res = x if mask is None else x * mask
            out = out + self.res_bn(self.res_conv(res))
        return F.relu(out)


class _AttentivePool(nn.Module):
    """TDNN attention over [x, mean, std], masked softmax over time, then
    attention-weighted mean and std: (B, C, T) -> (B, 2C)."""

    eps = 1e-10

    def __init__(self, channels: int, attention_channels: int = 128,
                 generator=None):
        super().__init__()
        self.tdnn_conv = _conv(3 * channels, attention_channels, 1,
                               bias=True, generator=generator)
        self.tdnn_bn = nn.BatchNorm1d(attention_channels)
        self.attn_conv = _conv(attention_channels, channels, 1, bias=True,
                               generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        if mask is None:
            mask = x.new_ones(x.shape[0], 1, x.shape[2])
        w = mask / torch.clamp(mask.sum(dim=2, keepdim=True), min=1.0)
        mean = (x * w).sum(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(((x - mean).square() * w).sum(
            dim=2, keepdim=True), min=self.eps))
        context = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        a = torch.tanh(self.tdnn_bn(F.relu(self.tdnn_conv(context))))
        a = self.attn_conv(a).masked_fill(mask == 0, float("-inf"))
        alpha = torch.softmax(a, dim=2)
        mu = (alpha * x).sum(dim=2)
        sg = torch.sqrt(torch.clamp((alpha * (x - mu[..., None]).square())
                                    .sum(dim=2), min=self.eps))
        return torch.cat([mu, sg], dim=1)


def _normalize_block(block: Mapping) -> Dict:
    """A block config with NeMo's one-element lists unwrapped; a stride
    other than 1 raises (conv shapes do not show it, so a strided
    encoder would load and run at the wrong frame rate)."""
    b = dict(block)
    for key in ("kernel", "dilation", "stride"):
        v = b.get(key)
        if isinstance(v, (list, tuple)):
            b[key] = v[0]
    stride = b.pop("stride", 1)
    if int(stride) != 1:
        raise ValueError("only stride-1 ConvASREncoder blocks are supported "
                         f"(TitaNet layout); got stride={stride}")
    return b


class TitaNet(nn.Module):
    """TitaNet on NeMo's mel features: (B, 1, samples) -> (B, emb_dim)."""

    def __init__(self, sample_rate: int = 16000, num_channels: int = 1,
                 n_mels: int = 80, blocks: Optional[Sequence[Mapping]] = None,
                 emb_dim: int = 192, attention_channels: int = 128,
                 n_fft: int = 512, win_length: int = 400,
                 hop_length: int = 160,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.blocks: List[Dict] = [_normalize_block(b) for b in
                                   (blocks or TITANET_LARGE_BLOCKS)]
        self.emb_dim = self.dimension = emb_dim
        self.attention_channels = attention_channels
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        encoder, cin = [], n_mels
        for cfg in self.blocks:
            encoder.append(_JasperBlock(
                cin, int(cfg["filters"]), repeat=int(cfg.get("repeat", 1)),
                kernel=int(cfg["kernel"]),
                dilation=int(cfg.get("dilation", 1)),
                residual=bool(cfg.get("residual", False)),
                separable=bool(cfg.get("separable", False)),
                se=bool(cfg.get("se", True)), generator=generator))
            cin = int(cfg["filters"])
        self.encoder = nn.ModuleList(encoder)
        self.pool = _AttentivePool(cin, attention_channels, generator)
        self.emb_bn = nn.BatchNorm1d(2 * cin)
        self.emb = _conv(2 * cin, emb_dim, 1, bias=True, generator=generator)

    def num_frames(self, num_samples: int) -> int:
        return nemo_mel_num_frames(num_samples, self.hop_length)

    @property
    def min_num_samples(self) -> int:
        """4 x ``win_length`` (0.1 s at 16 kHz), as in the JAX package:
        shorter rows are NaN, as NeMo's bisected bound makes them."""
        return 4 * self.win_length

    def mel(self, signals: torch.Tensor,
            frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return nemo_mel_spectrogram(
            signals, n_mels=self.n_mels, sample_rate=self.sample_rate,
            n_fft=self.n_fft, win_length=self.win_length,
            hop_length=self.hop_length, frame_mask=frame_mask)

    def forward_features(self, feats: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """(B, T, n_mels) mel features [+ (B, T) binary mask] -> (B, dim)."""
        with exact_float32():
            m = None if mask is None else mask[:, None, :].to(feats.dtype)
            x = feats.transpose(1, 2)
            if m is not None:
                x = x * m
            for block in self.encoder:
                x = block(x, m)
            pooled = self.emb_bn(self.pool(x, m))
            return self.emb(pooled[..., None])[..., 0]

    def forward_with_frame_mask(self, signals: torch.Tensor,
                                frame_mask: Optional[torch.Tensor]
                                ) -> torch.Tensor:
        """(B, samples) compacted signals + (B, frames) binary mask ->
        (B, dim): the NeMo wrapper's entry. The mask also bounds the mel
        normalisation's statistics."""
        return self.forward_features(self.mel(signals, frame_mask),
                                     frame_mask)

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, [1,] samples) [+ (B, frames) weights at any rate,
        nearest-interpolated to mel frames and binarized at 0.5]."""
        mask = None
        if weights is not None:
            mask = nearest_binary_mask(
                weights, self.num_frames(waveforms.shape[-1])).float()
        return self.forward_with_frame_mask(waveforms, mask)

    # -- NeMo checkpoints -----------------------------------------------------

    def convert_nemo_state_dict(self, state: Mapping[str, np.ndarray]
                                ) -> "TitaNet":
        """Load a NeMo ``EncDecSpeakerLabelModel`` state dict:

        - ``encoder.encoder.{i}.mconv.{j}.conv.weight``: the convs, in
          order (depthwise then pointwise where separable);
        - ``encoder.encoder.{i}.mconv.{j}.{weight, bias, running_*}``: the
          batch norms; ``...mconv.{j}.fc.{0,2}.*``: the SE;
        - ``encoder.encoder.{i}.res.0.{0,1}.*``: residual conv and BN;
        - ``decoder._pooling.attention_layer.{0,2}.*``: the pooling;
        - ``decoder.emb_layers.0.{0,1}.*``: BN + 1x1 conv;
        - ``decoder.final.*``: the classifier, dropped.
        """
        state = {k: np.asarray(v) for k, v in state.items()}
        ours: Dict[str, np.ndarray] = {}

        def put(dst: str, src: str) -> None:
            ours[dst] = state[src]

        def put_bn(dst: str, src: str) -> None:
            for name in ("weight", "bias", "running_mean", "running_var"):
                put(f"{dst}.{name}", f"{src}.{name}")

        for i, cfg in enumerate(self.blocks):
            prefix = f"encoder.encoder.{i}"

            def ids(pattern: str, prefix: str = prefix) -> List[int]:
                return sorted(int(m.group(1)) for k in state
                              if k.startswith(prefix + ".mconv.")
                              for m in [re.fullmatch(
                                  pattern, k[len(prefix) + 1:])] if m)

            conv_ids = ids(r"mconv\.(\d+)\.conv\.weight")
            bn_ids = ids(r"mconv\.(\d+)\.weight")
            se_ids = ids(r"mconv\.(\d+)\.fc\.0\.weight")
            separable = bool(cfg.get("separable", False))
            repeat = int(cfg.get("repeat", 1))
            if len(conv_ids) != (2 if separable else 1) * repeat:
                raise ValueError(
                    f"block {i}: found {len(conv_ids)} convs, expected "
                    f"{(2 if separable else 1) * repeat} "
                    f"(separable={separable}, repeat={repeat})")
            if len(bn_ids) != repeat:
                raise ValueError(f"block {i}: found {len(bn_ids)} batch "
                                 f"norms, expected {repeat}")
            dst = f"encoder.{i}"
            for r in range(repeat):
                if separable:
                    put(f"{dst}.dw.{r}.weight",
                        f"{prefix}.mconv.{conv_ids[2 * r]}.conv.weight")
                    put(f"{dst}.pw.{r}.weight",
                        f"{prefix}.mconv.{conv_ids[2 * r + 1]}.conv.weight")
                else:
                    put(f"{dst}.conv.{r}.weight",
                        f"{prefix}.mconv.{conv_ids[r]}.conv.weight")
                put_bn(f"{dst}.bn.{r}", f"{prefix}.mconv.{bn_ids[r]}")
            if cfg.get("se", True):
                if not se_ids:
                    raise ValueError(f"block {i}: missing SE weights")
                for ours_fc, theirs in (("fc1", "fc.0"), ("fc2", "fc.2")):
                    for name in ("weight", "bias"):
                        put(f"{dst}.se.{ours_fc}.{name}",
                            f"{prefix}.mconv.{se_ids[0]}.{theirs}.{name}")
            if cfg.get("residual", False):
                put(f"{dst}.res_conv.weight", f"{prefix}.res.0.0.conv.weight")
                put_bn(f"{dst}.res_bn", f"{prefix}.res.0.1")
        pool = "decoder._pooling.attention_layer"
        for name in ("weight", "bias"):
            put(f"pool.tdnn_conv.{name}", f"{pool}.0.conv_layer.{name}")
            put(f"pool.attn_conv.{name}", f"{pool}.2.{name}")
            put(f"emb.{name}", f"decoder.emb_layers.0.1.{name}")
        put_bn("pool.tdnn_bn", f"{pool}.0.bn")
        put_bn("emb_bn", "decoder.emb_layers.0.0")
        tensors = {k: torch.tensor(v.astype(np.float32))
                   for k, v in ours.items()}
        for key in self.state_dict():
            if key.endswith("num_batches_tracked"):
                tensors[key] = torch.tensor(0)
        self.load_state_dict(tensors, strict=True)
        return self

    @classmethod
    def from_nemo(cls, source: Union[str, Path], **kwargs) -> "TitaNet":
        """Load a local ``.nemo`` tar or a directory holding
        ``model_config.yaml`` and ``model_weights.ckpt`` (needs PyYAML);
        the module comes back on the CPU in eval mode. ``kwargs``
        (``revision``, ``token``, ``cache_dir``) are accepted and unused:
        there is no hub access."""
        config, state = _load_nemo_archive(source)
        model = cls(**_model_kwargs_from_config(config))
        return model.convert_nemo_state_dict(state).eval()


def _model_kwargs_from_config(config: Mapping) -> Dict:
    """``model_config.yaml`` -> TitaNet constructor arguments."""
    pre = config.get("preprocessor", {}) or {}
    enc = config.get("encoder", {}) or {}
    dec = config.get("decoder", {}) or {}

    def first(v):
        return v[0] if isinstance(v, (list, tuple)) else v

    blocks = [dict(filters=int(blk["filters"]),
                   repeat=int(blk.get("repeat", 1)),
                   kernel=int(first(blk.get("kernel", [3]))),
                   dilation=int(first(blk.get("dilation", [1]))),
                   # kept so that the constructor refuses a strided encoder
                   stride=int(first(blk.get("stride", [1]))),
                   residual=bool(blk.get("residual", False)),
                   separable=bool(blk.get("separable", False)),
                   se=bool(blk.get("se", True)))
              for blk in enc.get("jasper", []) or []]
    sample_rate = int(pre.get("sample_rate", 16000))
    window = str(pre.get("window", "hann")).lower()
    if window != "hann":
        raise ValueError(f"unsupported preprocessor window {window!r} (only "
                         f"'hann', the TitaNet family's, is implemented)")
    normalize = pre.get("normalize", "per_feature")
    if normalize != "per_feature":
        raise ValueError(f"unsupported preprocessor normalize {normalize!r}")
    win_length = int(round(float(pre.get("window_size", 0.025))
                           * sample_rate))
    hop_length = int(round(float(pre.get("window_stride", 0.01))
                           * sample_rate))
    kwargs = {"sample_rate": sample_rate,
              "n_mels": int(pre.get("features", 80)),
              "emb_dim": int(first(dec.get("emb_sizes", 192))),
              "attention_channels": int(dec.get("attention_channels", 128)),
              "n_fft": int(pre.get("n_fft")
                           or 1 << (win_length - 1).bit_length()),
              "win_length": win_length, "hop_length": hop_length}
    if blocks:
        kwargs["blocks"] = blocks
    return kwargs


def _load_nemo_archive(source: Union[str, Path]):
    """(config dict, state dict) of a local ``.nemo`` tar or directory."""
    import yaml

    path = Path(source)
    if not path.exists():
        raise ValueError(f"no .nemo checkpoint at {source!r}: this package "
                         f"loads local checkpoints only (it has no hub "
                         f"access)")
    if path.is_dir():
        config_bytes = (path / "model_config.yaml").read_bytes()
        state = _torch_load((path / "model_weights.ckpt").read_bytes())
    else:
        with tarfile.open(path, "r:*") as tar:
            names = tar.getnames()

            def member(basename: str) -> str:
                # NeMo's "./"-prefixed members, but not AppleDouble
                # "._model_weights.ckpt" entries of repacked archives
                for name in names:
                    if name.rsplit("/", 1)[-1] == basename:
                        return name
                raise FileNotFoundError(f"{basename} not found in {path} "
                                        f"(members: {names[:10]}...)")

            config_bytes = tar.extractfile(
                member("model_config.yaml")).read()
            state = _torch_load(
                tar.extractfile(member("model_weights.ckpt")).read())
    return yaml.safe_load(config_bytes), state


def _torch_load(data: bytes) -> Dict[str, np.ndarray]:
    state = torch.load(io.BytesIO(data), map_location="cpu",
                       weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()}


def _mconv_layout(cfg: Mapping) -> Dict[str, int]:
    """NeMo JasperBlock ``mconv`` indices of one block: per repeat the
    conv(s) and the BN, an activation and a dropout (no parameters, but
    indices) between repeats, the SE last."""
    layout: Dict[str, int] = {}
    idx = 0
    repeat = int(cfg.get("repeat", 1))
    for r in range(repeat):
        if cfg.get("separable", False):
            layout[f"dw.{r}"], layout[f"pw.{r}"] = idx, idx + 1
            layout[f"bn.{r}"] = idx + 2
            idx += 3
        else:
            layout[f"conv.{r}"], layout[f"bn.{r}"] = idx, idx + 1
            idx += 2
        if r != repeat - 1:
            idx += 2                      # activation + dropout
    if cfg.get("se", True):
        layout["se"] = idx
    return layout


def export_nemo_state_dict(model: TitaNet) -> Dict[str, np.ndarray]:
    """The module's weights in NeMo's ``EncDecSpeakerLabelModel`` layout
    (the classification head zero-filled: embeddings never use it)."""
    ours = {k: v.detach().cpu().numpy().astype(np.float32)
            if v.is_floating_point() else v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}
    state: Dict[str, np.ndarray] = {}

    def put_bn(dst: str, src: str) -> None:
        for name in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            state[f"{dst}.{name}"] = ours[f"{src}.{name}"]

    for i, cfg in enumerate(model.blocks):
        prefix, src = f"encoder.encoder.{i}", f"encoder.{i}"
        for name, idx in _mconv_layout(cfg).items():
            if name.startswith("bn."):
                put_bn(f"{prefix}.mconv.{idx}", f"{src}.{name}")
            elif name == "se":
                for ours_fc, theirs in (("fc1", "fc.0"), ("fc2", "fc.2")):
                    for p in ("weight", "bias"):
                        state[f"{prefix}.mconv.{idx}.{theirs}.{p}"] = \
                            ours[f"{src}.se.{ours_fc}.{p}"]
            else:
                state[f"{prefix}.mconv.{idx}.conv.weight"] = \
                    ours[f"{src}.{name}.weight"]
        if cfg.get("residual", False):
            state[f"{prefix}.res.0.0.conv.weight"] = \
                ours[f"{src}.res_conv.weight"]
            put_bn(f"{prefix}.res.0.1", f"{src}.res_bn")
    pool = "decoder._pooling.attention_layer"
    for p in ("weight", "bias"):
        state[f"{pool}.0.conv_layer.{p}"] = ours[f"pool.tdnn_conv.{p}"]
        state[f"{pool}.2.{p}"] = ours[f"pool.attn_conv.{p}"]
    put_bn(f"{pool}.0.bn", "pool.tdnn_bn")
    put_bn("decoder.emb_layers.0.0", "emb_bn")
    state["decoder.emb_layers.0.1.weight"] = ours["emb.weight"]
    state["decoder.emb_layers.0.1.bias"] = ours["emb.bias"]
    state["decoder.final.weight"] = np.zeros((7, model.emb_dim), np.float32)
    return state


def export_nemo_checkpoint(model: TitaNet, path: Union[str, Path]) -> Path:
    """Write ``model`` as a ``.nemo`` archive (``model_config.yaml`` +
    ``model_weights.ckpt``), which ``TitaNet.from_nemo`` reads back;
    ``path`` is the file, or a directory to hold ``model.nemo``."""
    import yaml

    config = {
        "preprocessor": {"sample_rate": model.sample_rate,
                         "features": model.n_mels, "n_fft": model.n_fft,
                         "window_size": model.win_length / model.sample_rate,
                         "window_stride": model.hop_length
                         / model.sample_rate,
                         "normalize": "per_feature", "window": "hann"},
        "encoder": {"feat_in": model.n_mels, "jasper": [
            {"filters": b["filters"], "repeat": b.get("repeat", 1),
             "kernel": [b["kernel"]], "stride": [1],
             "dilation": [b.get("dilation", 1)],
             "residual": b.get("residual", False),
             "separable": b.get("separable", False),
             "se": b.get("se", True), "se_context_size": -1}
            for b in model.blocks]},
        "decoder": {"feat_in": model.blocks[-1]["filters"],
                    "num_classes": 7, "pool_mode": "attention",
                    "emb_sizes": model.emb_dim,
                    "attention_channels": model.attention_channels,
                    "angular": True},
    }
    weights = io.BytesIO()
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in export_nemo_state_dict(model).items()}, weights)
    path = Path(path)
    if path.is_dir() or path.suffix == "":
        path.mkdir(parents=True, exist_ok=True)
        path = path / "model.nemo"
    with tarfile.open(path, "w:gz") as tar:
        for name, payload in (("./model_config.yaml",
                               yaml.safe_dump(config).encode()),
                              ("./model_weights.ckpt", weights.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return path
