"""Config-driven pipelines: hyperparameters, registries, loading, devices.

Counterpart of pyannote_audio_tpu/core/pipeline.py. Attribute assignment
routes declared hyperparameters (``core/parameter.py``), sub-pipelines,
models (``torch.nn.Module``) and ``Inference`` objects into registries;
``instantiate`` sets concrete values (a ``ParamDict`` merges, frozen keys
stay pinned) and ``freeze`` pins them. ``from_pretrained`` builds a
pipeline from a config dict, a ``config.yaml`` file or a local snapshot
directory, expanding ``$model/{subfolder}[@revision]`` placeholders; class
paths that name the reference (``pyannote.audio.``) or the JAX package
(``pyannote_audio_tpu.``) resolve to this package. A hub id resolves
through ``utils/hf_hub.py``: the ``PYANNOTE_TPU_HUB`` snapshot roots, the
download cache, then an HTTP download from ``HF_ENDPOINT``; its
placeholders keep the hub id, so each sub-model's files resolve the same
way. ``to(device)`` moves every registered model and ``Inference``.

A list of files goes to the subclass's ``apply_batch`` when it has one,
else through ``apply`` one file after another while a worker thread
decodes the next. ``config.yaml`` is read and written by
``utils/yaml_subset.py`` (no PyYAML).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import threading
from collections.abc import Mapping, MutableMapping
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import nn

from ..telemetry.spans import span
from ..utils import native, yaml_subset
from ..utils.runtime import check_device
from .inference import Inference, pin_waveform
from .io import Audio, AudioFile, get_audio_metadata
from .parameter import Frozen, ParamDict, Parameter

PIPELINE_CONFIG = "config.yaml"

# class paths of the reference and of the JAX package, which a config may
# name; both resolve to this package and are never imported
_FOREIGN_PACKAGES = ("pyannote.audio", "pyannote_audio_tpu")
_PACKAGE = "pyannote_audio_tpu_torch"

_REGISTRIES = ("_models", "_inferences", "_parameters", "_instantiated",
               "_pipelines", "_frozen", "_preprocessors")


def expand_subfolders(config: Any, model_id: str, token=None,
                      cache_dir=None) -> Any:
    """Rewrite ``$model/{subfolder}[@revision]`` strings of a config into
    ``{"checkpoint": model_id, "subfolder": ..., "revision": ...}``
    dicts, recursively; the caller's hub ``token`` and ``cache_dir`` ride
    along, so that a gated repo's sub-models authenticate."""
    if isinstance(config, dict):
        return {k: expand_subfolders(v, model_id, token, cache_dir)
                for k, v in config.items()}
    if isinstance(config, list):
        return [expand_subfolders(v, model_id, token, cache_dir)
                for v in config]
    if isinstance(config, str) and config.startswith("$model"):
        rest = config[len("$model"):]
        revision = None
        if "@" in rest:
            rest, revision = rest.split("@", 1)
        subfolder = rest.lstrip("/")
        out: Dict[str, Any] = {"checkpoint": model_id}
        if subfolder:
            out["subfolder"] = subfolder
        if revision:
            out["revision"] = revision
        if token is not None:
            out["token"] = token
        if cache_dir is not None:
            out["cache_dir"] = cache_dir
        return out
    return config


def port_module_name(module_name: str) -> str:
    """``pyannote.audio.x`` and ``pyannote_audio_tpu.x`` ->
    ``pyannote_audio_tpu_torch.x``; any other module name is kept."""
    for prefix in _FOREIGN_PACKAGES:
        if module_name == prefix or module_name.startswith(prefix + "."):
            return _PACKAGE + module_name[len(prefix):]
    return module_name


def get_class_by_name(name: str,
                      default_module_name: Optional[str] = None) -> type:
    """Import ``package.module.Class``, reading reference and JAX package
    paths as this package's."""
    tokens = name.split(".")
    if len(tokens) == 1:
        if default_module_name is None:
            raise ValueError(f"cannot resolve class name {name!r}")
        module_name, class_name = default_module_name, name
    else:
        module_name, class_name = ".".join(tokens[:-1]), tokens[-1]
    module = importlib.import_module(port_module_name(module_name))
    return getattr(module, class_name)


class _DotDict(dict):
    """Attribute access over an instantiated ``ParamDict``."""

    __getattr__ = dict.__getitem__

    def __setattr__(self, k, v):
        self[k] = v


class Pipeline:
    """Base pipeline: declared hyperparameters, sub-pipelines, models.

    ``apply(file, hook=None, **kwargs)`` is the subclass's work.
    """

    instantiated = False
    # pipelines with a training cache reuse their segmentation while set
    training = False

    def __init__(self):
        for name in _REGISTRIES:
            self.__dict__.setdefault(name, {})

    def _registry(self, name: str) -> Dict[str, Any]:
        return self.__dict__.setdefault(name, {})

    # -- attribute registries -------------------------------------------------

    def __setattr__(self, name: str, value: Any):
        for registry in ("_models", "_inferences", "_parameters",
                         "_pipelines", "_instantiated"):
            self._registry(registry).pop(name, None)
        if isinstance(value, nn.Module):
            self._registry("_models")[name] = value
        elif isinstance(value, Inference):
            self._registry("_inferences")[name] = value
        elif isinstance(value, Parameter):
            self._registry("_parameters")[name] = value
        elif isinstance(value, Pipeline):
            self._registry("_pipelines")[name] = value
        object.__setattr__(self, name, value)

    # -- hyperparameters --------------------------------------------------------

    def parameters(self, instantiated: bool = False) -> Dict[str, Any]:
        """Flat ``{name: Parameter}`` of this pipeline and its
        sub-pipelines (``"clustering.threshold"``), or their concrete
        values with ``instantiated=True``."""
        own = "_instantiated" if instantiated else "_parameters"
        params = dict(self._registry(own))
        for name, sub in self._registry("_pipelines").items():
            for k, v in sub.parameters(instantiated=instantiated).items():
                params[f"{name}.{k}"] = v
        return params

    def instantiate(self, params: Mapping) -> "Pipeline":
        """Set concrete values for the declared hyperparameters; a dict
        for a sub-pipeline goes to its ``instantiate``."""
        for name, value in (params or {}).items():
            self._instantiate_one(name, value)
        self.instantiated = True
        return self

    def _instantiate_one(self, name: str, value: Any):
        declared = self._registry("_parameters").get(name)
        if isinstance(declared, ParamDict) and isinstance(value, Mapping):
            previous = self._registry("_instantiated").get(name) or {}
            merged = {}
            for k in declared:
                # a frozen key stays pinned; a key absent from a partial
                # dict keeps its current value
                if isinstance(declared[k], Frozen):
                    merged[k] = declared[k].value
                else:
                    merged[k] = value.get(k, previous.get(k))
            self._registry("_instantiated")[name] = merged
            object.__setattr__(self, name, _DotDict(merged))
        elif declared is not None:
            if isinstance(declared, Frozen):
                value = declared.value
            self._registry("_instantiated")[name] = value
            object.__setattr__(self, name, value)
        elif name in self._registry("_pipelines"):
            self._registry("_pipelines")[name].instantiate(value)
        else:
            # undeclared: set it all the same (forward compatibility)
            object.__setattr__(self, name, value)

    def freeze(self, params: Mapping) -> "Pipeline":
        """Pin hyperparameters: each declared one becomes ``Frozen``, so a
        later ``instantiate`` cannot change it."""
        for name, value in (params or {}).items():
            if name in self._registry("_pipelines"):
                self._registry("_pipelines")[name].freeze(value)
                continue
            declared = self._registry("_parameters").get(name)
            if isinstance(declared, ParamDict) and isinstance(value, Mapping):
                for k, v in value.items():
                    if k in declared:
                        declared[k] = Frozen(v)
            elif declared is not None:
                self._registry("_parameters")[name] = Frozen(value)
            self._registry("_frozen")[name] = value
            self._instantiate_one(name, value)
        return self

    def default_parameters(self) -> Dict[str, Any]:
        raise NotImplementedError(
            f"{type(self).__name__} has no default parameters")

    # -- loading ----------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, checkpoint: Union[Dict, str, Path],
                        device: Optional[Union[str, torch.device]] = None,
                        pipeline_params: Optional[Dict] = None,
                        **hub_kwargs) -> "Pipeline":
        """Build a pipeline from a config dict, a ``config.yaml`` file, a
        local snapshot directory holding one, or a hub id.

        A dict's ``checkpoint`` key (default ".") is the root that
        ``$model/...`` placeholders point into; for a file or directory
        the root is the directory, for a hub id the id itself, whose
        ``config.yaml`` and sub-model files ``utils/hf_hub.py`` resolves
        with ``token`` (or ``use_auth_token``), ``cache_dir`` and
        ``revision``. ``pipeline_params`` override the config's
        constructor ``params``; ``device``, where the pipeline class takes
        one, is passed to its constructor.
        """
        unknown = set(hub_kwargs) - {"token", "use_auth_token", "cache_dir",
                                     "revision"}
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        token = hub_kwargs.get("token") or hub_kwargs.get("use_auth_token")
        cache_dir = hub_kwargs.get("cache_dir")
        if isinstance(checkpoint, Mapping):
            config = dict(checkpoint)
            model_id = str(config.get("checkpoint", "."))
        else:
            from ..utils.hf_hub import AssetFileName, hub_asset
            path = Path(checkpoint)
            found = hub_asset(checkpoint, AssetFileName.Pipeline,
                              revision=hub_kwargs.get("revision"),
                              token=token, cache_dir=cache_dir)
            if found is not None:
                config_yml, model_id = found, str(checkpoint)
            elif path.is_dir():
                config_yml, model_id = path / PIPELINE_CONFIG, str(path)
            elif path.is_file():
                config_yml, model_id = path, str(path.parent)
            else:
                raise ValueError(
                    f"{checkpoint} is neither a directory, a config file "
                    f"nor a hub id")
            config = yaml_subset.load_file(config_yml)

        config = expand_subfolders(config, model_id, token=token,
                                   cache_dir=cache_dir)
        if "pipeline" not in config:
            raise ValueError("config has no 'pipeline' section")
        Klass = get_class_by_name(config["pipeline"]["name"],
                                  default_module_name=f"{_PACKAGE}.pipelines")
        params = dict(config["pipeline"].get("params") or {})
        params.update(pipeline_params or {})
        if device is not None:
            try:
                accepted = inspect.signature(Klass.__init__).parameters
            except (TypeError, ValueError):
                accepted = {}
            if "device" in accepted:
                params["device"] = device
        pipeline = Klass(**params)
        pipeline.__dict__["_config_params"] = params

        if "freeze" in config:
            pipeline.freeze(config["freeze"])
        if "params" in config:
            pipeline.instantiate(config["params"])

        preprocessors = {}
        for key, preprocessor in (config.get("preprocessors") or {}).items():
            if isinstance(preprocessor, Mapping) and "name" in preprocessor:
                Preprocessor = get_class_by_name(
                    preprocessor["name"],
                    default_module_name=f"{_PACKAGE}.utils.preprocessors")
                preprocessors[key] = Preprocessor(
                    **(preprocessor.get("params") or {}))
            else:
                preprocessors[key] = preprocessor
        if preprocessors:
            pipeline.__dict__["_preprocessors"] = preprocessors
        return pipeline

    def _instantiated_tree(self) -> Dict[str, Any]:
        """Concrete values, nested by sub-pipeline."""
        tree = {name: dict(value) if isinstance(value, Mapping) else value
                for name, value in self._registry("_instantiated").items()}
        for name, sub in self._registry("_pipelines").items():
            values = sub._instantiated_tree()
            if values:
                tree[name] = values
        return tree

    def dump_config(self) -> Dict[str, Any]:
        """The config that ``from_pretrained`` reads back: the class, its
        constructor params (those it was loaded with), the frozen and the
        instantiated hyperparameters."""
        params = {k: str(v) if isinstance(v, torch.device) else v
                  for k, v in self.__dict__.get("_config_params",
                                                {}).items()}
        config: Dict[str, Any] = {
            "pipeline": {"name": f"{type(self).__module__}."
                                 f"{type(self).__name__}",
                         "params": params},
            "params": self._instantiated_tree()}
        if self._registry("_frozen"):
            config["freeze"] = dict(self._registry("_frozen"))
        return config

    def save_config(self, path: Union[str, Path]) -> Path:
        """Write ``dump_config()`` to ``path/config.yaml``."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        return yaml_subset.dump_file(self.dump_config(),
                                     path / PIPELINE_CONFIG)

    # -- devices ----------------------------------------------------------------

    def to(self, device: Union[str, torch.device]) -> "Pipeline":
        """Move every registered model, ``Inference`` and sub-pipeline to
        ``device``; a CUDA device without a card raises."""
        device = check_device(device)
        for model in self._registry("_models").values():
            model.to(device)
        for inference in self._registry("_inferences").values():
            inference.to(device)
        for sub in self._registry("_pipelines").values():
            sub.to(device)
        object.__setattr__(self, "device", device)
        return self

    def cuda(self, device: Optional[Union[int, torch.device]] = None
             ) -> "Pipeline":
        """``to`` the CUDA card (card ``device`` when an index is given)."""
        if device is None or isinstance(device, int):
            device = torch.device("cuda", device or 0)
        return self.to(device)

    # -- applying ---------------------------------------------------------------

    def prepare_one(self, file: AudioFile) -> MutableMapping:
        """A validated file dict, with each preprocessor's output stored
        under its key."""
        file = Audio.validate_file(file)
        for key, preprocessor in self._registry("_preprocessors").items():
            file[key] = preprocessor(file)
        return file

    def default_hook(self) -> Callable:
        def hook(step_name, step_artifact, file=None, total=None,
                 completed=None):
            pass
        return hook

    def setup_hook(self, file: AudioFile,
                   hook: Optional[Callable] = None) -> Callable:
        """``hook`` with ``file`` bound into every call, or a no-op."""
        if hook is None:
            return lambda *args, **kwargs: None
        return functools.partial(hook, file=file)

    def __call__(self, file: Union[AudioFile, List[AudioFile]],
                 hook: Optional[Callable] = None, **kwargs):
        """Apply to one file, or to a list (any iterable that is not a
        path or a mapping) of files through ``_apply_batch``. Each call
        is one ``pipeline_apply`` telemetry event (opt-in, ``telemetry``)
        and one span (``apply`` or ``apply_batch``, ``telemetry/spans.py``)
        while spans are recorded."""
        from ..telemetry import track_pipeline_apply
        track_pipeline_apply(self, file,
                             num_speakers=kwargs.get("num_speakers"),
                             min_speakers=kwargs.get("min_speakers"),
                             max_speakers=kwargs.get("max_speakers"))
        if not self.instantiated:
            try:
                self.instantiate(self.default_parameters())
            except NotImplementedError:
                concrete = self.parameters(instantiated=True)
                missing = [k for k in self.parameters() if k not in concrete]
                if missing:
                    raise RuntimeError(
                        f"{type(self).__name__} has no default parameters "
                        f"and {missing} are not instantiated; call "
                        f"instantiate(...) before applying it.") from None
                self.instantiated = True
        if isinstance(file, (list, tuple)) or (
                hasattr(file, "__iter__")
                and not isinstance(file, (str, Path, Mapping))
                and not hasattr(file, "read")):
            with span("apply_batch"):
                return self._apply_batch(list(file), hook=hook, **kwargs)
        file = self.prepare_one(file)
        # stateful hooks (TimingHook, ArtifactHook) write into the file
        with span("apply", file):
            return self.apply(file, hook=self.setup_hook(file, hook),
                              **kwargs)

    def _apply_batch(self, files: List[AudioFile],
                     hook: Optional[Callable] = None, **kwargs):
        """Apply to a list of files.

        A subclass with an ``apply_batch`` gets the prepared files. One
        that streams its own decode (``STREAMS_DECODE``) gets them as they
        are; any other would first get them decoded by
        ``_predecode_batch``. Without ``apply_batch`` the files run through
        ``apply`` one after another while a worker thread decodes the
        next, and each file's device buffers (and the host waveform this
        machinery decoded) are dropped once it is done: the list keeps
        every dict alive until the end.
        """
        files = [self.prepare_one(f) for f in files]
        apply_batch = getattr(self, "apply_batch", None)
        if apply_batch is not None:
            if not getattr(self, "STREAMS_DECODE", False):
                self._predecode_batch(files)
            return apply_batch(files, hook=hook, **kwargs)

        prefetch: Dict[int, threading.Thread] = {}
        results = []
        try:
            for i, f in enumerate(files):
                t = prefetch.pop(i, None)
                if t is not None:
                    t.join()
                else:
                    self._decode_into(f)
                if i + 1 < len(files):
                    t = threading.Thread(target=self._decode_into,
                                         args=(files[i + 1],), daemon=True)
                    t.start()
                    prefetch[i + 1] = t
                results.append(self.apply(f, hook=self.setup_hook(f, hook),
                                          **kwargs))
                _evict(f)
        finally:
            for t in prefetch.values():
                t.join()
        return results

    def _decode_into(self, f, preload: bool = True) -> None:
        """Decode a path-backed file dict in place (safe in a worker
        thread: host work only, unless ``preload``).

        Sets ``waveform``, ``sample_rate`` and the ``_batch_decoded``
        marker, which lets batch eviction drop the waveform again. For a
        pipeline on a CUDA device the waveform lands in page-locked memory,
        so its upload need not wait. Decode errors are left to the
        consumer, which decodes again and raises the real exception.
        ``preload`` also starts the file's upload (``self.preload``);
        pipelines that order uploads themselves pass False.
        """
        audio = getattr(self, "_audio", None) or Audio(sample_rate=16000)
        if isinstance(f, MutableMapping) and "waveform" not in f \
                and isinstance(f.get("audio"), (str, Path)):
            try:
                waveform, sample_rate = audio(f)
            except (ValueError, OSError):
                return
            device = getattr(self, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                waveform = pin_waveform(waveform)
            f["waveform"] = waveform
            f["sample_rate"] = sample_rate
            f["_batch_decoded"] = True
        if preload:
            try:
                self.preload(f)
            except (ValueError, OSError):
                pass               # the consumer uploads and raises

    def _predecode_batch(self, files: List[Dict]) -> None:
        """Decode a batch's path-backed WAV files ahead of
        ``apply_batch``, in parallel, with the native batch decoder
        (decode, downmix, resample to the pipeline's rate).

        Files with a ``channel`` key, or a batch with a file the decoder
        cannot read, are left to be decoded where they are consumed. The
        waveforms land with the ``_batch_decoded`` marker (in page-locked
        memory for a pipeline on a CUDA device), as ``_decode_into`` puts
        them.
        """
        audio = getattr(self, "_audio", None) or Audio(sample_rate=16000)
        pending = [f for f in files
                   if isinstance(f, MutableMapping) and "waveform" not in f
                   and isinstance(f.get("audio"), (str, Path))
                   and f.get("channel") is None]
        if len(pending) < 2 or audio.mono not in (None, "downmix"):
            return
        sample_rate = audio.sample_rate or 16000
        try:
            max_seconds = max(get_audio_metadata(f).duration
                              for f in pending)
        except (ValueError, OSError):
            return
        decoded = native.batch_decode_resample(
            [str(f["audio"]) for f in pending], sample_rate,
            max_seconds=max_seconds + 0.1)
        if decoded is None:
            return
        device = getattr(self, "device", None)
        pin = device is not None and torch.device(device).type == "cuda"
        for f, row, n in zip(pending, *decoded):
            waveform = row[None, :int(n)]
            f["waveform"] = pin_waveform(waveform) if pin else waveform.copy()
            f["sample_rate"] = sample_rate
            f["_batch_decoded"] = True

    def preload(self, file: Dict) -> None:
        """Start a file's device upload early; subclasses with a device
        path override this."""

    def apply(self, file: Dict, hook: Optional[Callable] = None, **kwargs):
        raise NotImplementedError


def _evict(f) -> None:
    """Drop a finished file's device buffers and, for a dict the batch
    machinery decoded itself, its host waveform. A waveform that came
    with the dict stays."""
    if isinstance(f, MutableMapping):
        f.pop("_device_waveform", None)
        f.pop("_longfile_uploads", None)
        if f.pop("_batch_decoded", None):
            f.pop("waveform", None)
            f.pop("sample_rate", None)
