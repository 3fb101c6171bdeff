"""Carry the JAX package's parameters across into the port's state dicts.

The input is a JAX model's ``model.params`` pytree (``{"params": ...}``,
plus ``"batch_stats"`` for WeSpeaker) whose leaves the caller has already
turned into numpy arrays; this module never sees JAX. The output is the
reference torch state-dict layout, i.e. exactly what the JAX model's
``export_torch_state_dict`` emits (the inverse of its
``convert_torch_state_dict``), ready for the port's
``load_reference_state_dict``. ``write_reference_checkpoint`` writes
such a state dict as a reference-layout ``pytorch_model.bin``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def pyannet_state_dict(params_np: Mapping, hparams: Mapping
                       ) -> Dict[str, np.ndarray]:
    """PyanNet params + its ``hparams`` ({"lstm": {"num_layers",
    "bidirectional"}, "linear": {"num_layers"}}) -> ``sincnet.*``,
    ``lstm.*``, ``linear.*``, ``classifier.*`` keys."""
    p = params_np["params"]
    sn = p["sincnet"]
    state = {
        "sincnet.wav_norm1d.weight": _f32(sn["wav_norm1d"]["scale"]),
        "sincnet.wav_norm1d.bias": _f32(sn["wav_norm1d"]["bias"]),
        "sincnet.conv1d.0.filterbank.low_hz_":
            _f32(sn["sinc_conv"]["low_hz"]).reshape(-1, 1),
        "sincnet.conv1d.0.filterbank.band_hz_":
            _f32(sn["sinc_conv"]["band_hz"]).reshape(-1, 1),
    }
    for i in (0, 1, 2):
        state[f"sincnet.norm1d.{i}.weight"] = _f32(sn[f"norm1d_{i}"]["scale"])
        state[f"sincnet.norm1d.{i}.bias"] = _f32(sn[f"norm1d_{i}"]["bias"])
    for i in (1, 2):
        # flax conv kernel (k, in, out) -> torch (out, in, k)
        state[f"sincnet.conv1d.{i}.weight"] = \
            _f32(sn[f"conv1d_{i}"]["kernel"]).transpose(2, 1, 0)
        state[f"sincnet.conv1d.{i}.bias"] = _f32(sn[f"conv1d_{i}"]["bias"])
    suffixes = ("", "_reverse") if hparams["lstm"]["bidirectional"] \
        else ("",)
    for i in range(hparams["lstm"]["num_layers"]):
        for suffix in suffixes:
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                state[f"lstm.{theirs}_l{i}{suffix}"] = \
                    _f32(p["lstm"][f"{ours}_l{i}{suffix}"])
    for i in range(hparams["linear"]["num_layers"]):
        # flax dense kernel (in, out) -> torch (out, in)
        state[f"linear.{i}.weight"] = _f32(p[f"linear_{i}"]["kernel"]).T
        state[f"linear.{i}.bias"] = _f32(p[f"linear_{i}"]["bias"])
    state["classifier.weight"] = _f32(p["classifier"]["kernel"]).T
    state["classifier.bias"] = _f32(p["classifier"]["bias"])
    return state


def wespeaker_state_dict(variables_np: Mapping) -> Dict[str, np.ndarray]:
    """WeSpeaker ResNet {"params", "batch_stats"} -> ``resnet.*`` keys,
    BatchNorm running statistics included."""
    params = variables_np["params"]["trunk"]
    stats = variables_np["batch_stats"]["trunk"]
    state: Dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        # kernel (time, freq, in, out) -> torch (out, in, freq, time)
        state[f"{prefix}.weight"] = _f32(p["kernel"]).transpose(3, 2, 1, 0)

    def put_bn(prefix, p, s):
        state[f"{prefix}.weight"] = _f32(p["scale"])
        state[f"{prefix}.bias"] = _f32(p["bias"])
        state[f"{prefix}.running_mean"] = _f32(s["mean"])
        state[f"{prefix}.running_var"] = _f32(s["var"])
        state[f"{prefix}.num_batches_tracked"] = np.asarray(0,
                                                            dtype=np.int64)

    put_conv("resnet.conv1", params["conv1"])
    put_bn("resnet.bn1", params["bn1"], stats["bn1"])
    blocks = sorted((tuple(int(g) for g in m.groups()), name)
                    for name in params
                    if (m := re.fullmatch(r"layer(\d+)_(\d+)", name)))
    for (stage, i), name in blocks:
        prefix = f"resnet.layer{stage}.{i}"
        block, block_stats = params[name], stats[name]
        c = 1
        while f"conv{c}" in block:
            put_conv(f"{prefix}.conv{c}", block[f"conv{c}"])
            put_bn(f"{prefix}.bn{c}", block[f"bn{c}"], block_stats[f"bn{c}"])
            c += 1
        if "shortcut_conv" in block:
            put_conv(f"{prefix}.shortcut.0", block["shortcut_conv"])
            put_bn(f"{prefix}.shortcut.1", block["shortcut_bn"],
                   block_stats["shortcut_bn"])
    seg_1 = variables_np["params"]["seg_1"]
    state["resnet.seg_1.weight"] = _f32(seg_1["kernel"]).T
    state["resnet.seg_1.bias"] = _f32(seg_1["bias"])
    return state


def arcface_prototypes(params_np: Mapping) -> np.ndarray:
    """The JAX ArcFace task's class prototypes (``params["arcface"]`` of
    its training parameters, (classes, dimension)) as the float32 array
    the port trains as ``task.arcface``."""
    return _f32(params_np["arcface"])


def write_reference_checkpoint(state_dict: Mapping, architecture: str,
                               hparams: Mapping, specifications,
                               path) -> Path:
    """Write a reference-layout ``pytorch_model.bin`` that this package's
    ``Model.from_pretrained`` and the JAX package's both read.

    ``path`` is the file, or a directory to hold ``pytorch_model.bin``.
    The checkpoint is ``{"state_dict": float32 tensors,
    "hyper_parameters": hparams, "pyannote.audio": {"architecture":
    {"module", "class"}, "specifications": a plain dict}}``: it pickles
    no class of either package. ``specifications`` is the port's
    ``Specifications``, a dict in its ``to_dict`` layout, a multi-task
    tuple of either, or None.
    """
    import torch
    path = Path(path)
    if path.suffix != ".bin":
        path = path / "pytorch_model.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(specifications, (list, tuple)):
        specifications = [s if isinstance(s, Mapping) else s.to_dict()
                          for s in specifications]
    elif specifications is not None and not isinstance(specifications,
                                                       Mapping):
        specifications = specifications.to_dict()
    vendor = {"architecture": {"module": "pyannote.audio",
                               "class": architecture}}
    if specifications is not None:
        vendor["specifications"] = list(specifications) \
            if isinstance(specifications, list) else dict(specifications)
    checkpoint = {
        "state_dict": {k: v.detach().cpu().clone()
                       if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.array(v))
                       for k, v in state_dict.items()},
        "hyper_parameters": dict(hparams),
        "pyannote.audio": vendor,
    }
    torch.save(checkpoint, path)
    return path


def _dense(p: Mapping):
    """flax Dense (kernel (in, out), bias) -> torch (weight, bias)."""
    return _f32(p["kernel"]).T, _f32(p["bias"])


def _lstm_keys(p: Mapping, prefix: str, num_layers: int,
               bidirectional: bool = True) -> Dict[str, np.ndarray]:
    """The JAX LSTM's ``w_ih_l{i}[_reverse]`` ... -> torch.nn.LSTM's
    names under ``prefix``."""
    out = {}
    for i in range(num_layers):
        for suffix in (("", "_reverse") if bidirectional else ("",)):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                out[f"{prefix}.{theirs}_l{i}{suffix}"] = \
                    _f32(p[f"{ours}_l{i}{suffix}"])
    return out


def ssl_state_dict(p: Mapping, layers: int) -> Dict[str, np.ndarray]:
    """A JAX ``SSLEncoder`` params tree -> HF wav2vec2 / WavLM names, what
    the JAX package's ``export_torch_wav2vec2`` writes. The positional
    conv's weight-norm pair is the fused kernel and its (out, in) norm."""
    state: Dict[str, np.ndarray] = {}
    fe = p["feature_extractor"]
    layer_mode = "layer_norm_1" in fe
    for i in range(7):
        base = f"feature_extractor.conv_layers.{i}"
        state[f"{base}.conv.weight"] = \
            _f32(fe[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)
        if "bias" in fe[f"conv_{i}"]:
            state[f"{base}.conv.bias"] = _f32(fe[f"conv_{i}"]["bias"])
        if layer_mode:
            state[f"{base}.layer_norm.weight"] = \
                _f32(fe[f"layer_norm_{i}"]["scale"])
            state[f"{base}.layer_norm.bias"] = \
                _f32(fe[f"layer_norm_{i}"]["bias"])
    if not layer_mode:
        state["feature_extractor.conv_layers.0.layer_norm.weight"] = \
            _f32(fe["group_norm"]["scale"])
        state["feature_extractor.conv_layers.0.layer_norm.bias"] = \
            _f32(fe["group_norm"]["bias"])
    state["feature_projection.layer_norm.weight"] = \
        _f32(p["feature_norm"]["scale"])
    state["feature_projection.layer_norm.bias"] = \
        _f32(p["feature_norm"]["bias"])
    (state["feature_projection.projection.weight"],
     state["feature_projection.projection.bias"]) = \
        _dense(p["feature_projection"])
    full = _f32(p["pos_conv"]["conv"]["kernel"]).transpose(2, 1, 0)
    state["encoder.pos_conv_embed.conv.weight_v"] = full
    state["encoder.pos_conv_embed.conv.weight_g"] = np.linalg.norm(
        full, axis=(0, 1), keepdims=True).astype(np.float32)
    state["encoder.pos_conv_embed.conv.bias"] = \
        _f32(p["pos_conv"]["conv"]["bias"])
    if "rel_pos" in p:
        state["encoder.layers.0.attention.rel_attn_embed.weight"] = \
            _f32(p["rel_pos"]["rel_attn_embed"])
    for i in range(layers):
        layer, base = p[f"layer_{i}"], f"encoder.layers.{i}"
        for ours, theirs in (("attn_norm", "layer_norm"),
                             ("ffn_norm", "final_layer_norm")):
            state[f"{base}.{theirs}.weight"] = _f32(layer[ours]["scale"])
            state[f"{base}.{theirs}.bias"] = _f32(layer[ours]["bias"])
        for ours, theirs in (("q", "attention.q_proj"),
                             ("k", "attention.k_proj"),
                             ("v", "attention.v_proj"),
                             ("out", "attention.out_proj"),
                             ("ffn_in", "feed_forward.intermediate_dense"),
                             ("ffn_out", "feed_forward.output_dense")):
            state[f"{base}.{theirs}.weight"], state[f"{base}.{theirs}.bias"] \
                = _dense(layer[ours])
        if "gru_rel_pos_linear" in layer:
            (state[f"{base}.attention.gru_rel_pos_linear.weight"],
             state[f"{base}.attention.gru_rel_pos_linear.bias"]) = \
                _dense(layer["gru_rel_pos_linear"])
            state[f"{base}.attention.gru_rel_pos_const"] = \
                _f32(layer["gru_rel_pos_const"])
    if "final_norm" in p:
        state["encoder.layer_norm.weight"] = _f32(p["final_norm"]["scale"])
        state["encoder.layer_norm.bias"] = _f32(p["final_norm"]["bias"])
    return state


def sseriouss_state_dict(params_np: Mapping, hparams: Mapping,
                         ssl_layers: int) -> Dict[str, np.ndarray]:
    """SSeRiouSS params + its ``hparams`` ({"lstm": {"num_layers",
    "bidirectional"}, "linear": {"num_layers"}}) -> the reference layout
    the JAX model's ``export_torch_state_dict`` writes: the trunk in
    torchaudio's nesting under ``wav2vec.*``, ``wav2vec_weights``, the
    monolithic ``lstm.*``, ``linear.{i}.*`` and ``classifier.*``."""
    from ..models.blocks.ssl import torchaudio_layout
    p = params_np["params"]
    state = {f"wav2vec.{k}": v for k, v in torchaudio_layout(
        ssl_state_dict(p["wav2vec"], ssl_layers)).items()}
    if "layer_weights" in p:
        state["wav2vec_weights"] = _f32(p["layer_weights"]).reshape(-1)
    state.update(_lstm_keys(p["lstm"], "lstm",
                            hparams["lstm"]["num_layers"],
                            hparams["lstm"]["bidirectional"]))
    for i in range(hparams["linear"]["num_layers"]):
        state[f"linear.{i}.weight"], state[f"linear.{i}.bias"] = \
            _dense(p[f"linear_{i}"])
    state["classifier.weight"], state["classifier.bias"] = \
        _dense(p["classifier"])
    return state


def totatonet_state_dict(params_np: Mapping, hparams: Mapping,
                         wavlm_layers: int = 0) -> Dict[str, np.ndarray]:
    """ToTaToNet params + its ``hparams`` ({"dprnn": {"n_repeats"},
    "linear": {"num_layers"}}) -> the reference layout the JAX model's
    ``export_torch_state_dict`` writes: asteroid's filterbanks (the
    decoder's in ``conv_transpose1d`` layout, un-flipped), gLN shapes and
    1x1 convs, ``linear.{i}``, ``classifier`` and, with the WavLM branch,
    its ``wavlm_layers`` layers under ``wavlm.*`` in HF names."""
    p = params_np["params"]
    state = {"encoder.filterbank._filters":
             _f32(p["encoder"]["kernel"]).transpose(2, 1, 0),
             "decoder.filterbank._filters":
             _f32(p["decoder"]["kernel"])[::-1].transpose(1, 2, 0).copy()}
    m = p["masker"]

    def put_norm(prefix, q):
        state[f"{prefix}.gamma"] = _f32(q["scale"]).reshape(1, -1, 1)
        state[f"{prefix}.beta"] = _f32(q["bias"]).reshape(1, -1, 1)

    def put_conv1x1(prefix, q, bias=True):
        state[f"{prefix}.weight"] = _f32(q["kernel"]).T[..., None]
        if bias:
            state[f"{prefix}.bias"] = _f32(q["bias"])

    put_norm("masker.bottleneck.0", m["in_norm"])
    put_conv1x1("masker.bottleneck.1", m["bottleneck"])
    for r in range(hparams["dprnn"]["n_repeats"]):
        blk, base = m[f"block_{r}"], f"masker.net.{r}"
        for which in ("intra", "inter"):
            state.update(_lstm_keys(blk[f"{which}_rnn"],
                                    f"{base}.{which}_RNN.rnn", 1))
            state[f"{base}.{which}_linear.weight"], \
                state[f"{base}.{which}_linear.bias"] = \
                _dense(blk[f"{which}_linear"])
            put_norm(f"{base}.{which}_norm", blk[f"{which}_norm"])
    state["masker.first_out.0.weight"] = \
        _f32(m["mask_prelu"]["negative_slope"]).reshape(1)
    state["masker.first_out.1.weight"] = \
        _f32(m["first_out"]["kernel"]).T[..., None, None]
    state["masker.first_out.1.bias"] = _f32(m["first_out"]["bias"])
    put_conv1x1("masker.net_out.0", m["net_out"])
    put_conv1x1("masker.net_gate.0", m["net_gate"])
    put_conv1x1("masker.mask_net", m["mask_net"], bias=False)
    for i in range(hparams["linear"]["num_layers"]):
        state[f"linear.{i}.weight"], state[f"linear.{i}.bias"] = \
            _dense(p[f"linears_{i}"])
    state["classifier.weight"], state["classifier.bias"] = \
        _dense(p["classifier"])
    if "wavlm" in p:
        state.update({f"wavlm.{k}": v for k, v in
                      ssl_state_dict(p["wavlm"], wavlm_layers).items()})
    return state


def debug_segmentation_state_dict(params_np: Mapping
                                  ) -> Dict[str, np.ndarray]:
    """SimpleSegmentationModel params -> ``frontend.*``, ``lstm.*``,
    ``classifier.*``."""
    p = params_np["params"]
    state = {"frontend.weight":
             _f32(p["frontend"]["kernel"]).transpose(2, 1, 0),
             "frontend.bias": _f32(p["frontend"]["bias"])}
    state.update(_lstm_keys(p["lstm"], "lstm", 1))
    state["classifier.weight"], state["classifier.bias"] = \
        _dense(p["classifier"])
    return state


def debug_embedding_state_dict(params_np: Mapping
                               ) -> Dict[str, np.ndarray]:
    """SimpleEmbeddingModel params -> ``frontend.*``, ``proj.*``."""
    p = params_np["params"]
    state = {"frontend.weight":
             _f32(p["frontend"]["kernel"]).transpose(2, 1, 0),
             "frontend.bias": _f32(p["frontend"]["bias"])}
    state["proj.weight"], state["proj.bias"] = _dense(p["proj"])
    return state
