"""Corpus protocols: train / development / test file iterators.

Counterpart of pyannote_audio_tpu/utils/database.py: a protocol yields
file dicts ``{uri, audio, annotation, annotated}`` for each subset, built
from in-memory lists or from RTTM / UEM / LST sidecar files, or declared
in a ``database.yml`` of pyannote.database's shape (``register_database``,
read by ``utils/yaml_subset.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

from ..core.annotation import Annotation, Timeline
from . import yaml_subset
from .rttm import load_lst, load_rttm, load_uem

PathLike = Union[str, Path]

_REGISTRY: Dict[str, "Protocol"] = {}


class Protocol:
    """A train / development / test split of annotated audio files."""

    def __init__(self, name: str = "",
                 subsets: Optional[Dict[str, List[Dict]]] = None):
        self.name = name
        self._subsets: Dict[str, List[Dict]] = subsets or {}

    def _iter(self, subset: str) -> Iterator[Dict]:
        for file in self._subsets.get(subset, []):
            yield dict(file)

    def train(self) -> Iterator[Dict]:
        return self._iter("train")

    def development(self) -> Iterator[Dict]:
        return self._iter("development")

    def test(self) -> Iterator[Dict]:
        return self._iter("test")

    def files(self) -> Iterator[Dict]:
        for subset in ("train", "development", "test"):
            yield from self._iter(subset)

    @staticmethod
    def from_files(name: str, rttm: PathLike,
                   lst: Optional[PathLike] = None,
                   uem: Optional[PathLike] = None,
                   audio_dir: Optional[PathLike] = None,
                   audio_template: str = "{uri}.wav",
                   subset: str = "train") -> "Protocol":
        """A one-subset protocol from sidecar files: the URIs of ``lst``
        (else every URI of ``rttm``), annotated where ``uem`` says (else
        over the annotation's extent)."""
        annotations = load_rttm(rttm)
        uris = load_lst(lst) if lst else sorted(annotations)
        uems = load_uem(uem) if uem else {}
        files = []
        for uri in uris:
            annotation = annotations.get(uri, Annotation(uri=uri))
            annotated = uems.get(uri)
            if annotated is None:
                extent = annotation.get_timeline().extent()
                annotated = Timeline([extent], uri=uri) if extent else \
                    Timeline(uri=uri)
            file = {"uri": uri, "annotation": annotation,
                    "annotated": annotated, "database": name}
            if audio_dir is not None:
                file["audio"] = str(
                    Path(audio_dir) / audio_template.format(uri=uri))
            files.append(file)
        return Protocol(name=name, subsets={subset: files})

    def merged_with(self, other: "Protocol") -> "Protocol":
        subsets = {k: list(v) for k, v in self._subsets.items()}
        for k, v in other._subsets.items():
            subsets.setdefault(k, []).extend(v)
        return Protocol(name=self.name, subsets=subsets)


def register_database(path: PathLike) -> None:
    """Load a database.yml and register its protocols as
    ``{database}.{task}.{protocol}``::

        Databases:
          MyDB: /path/to/{uri}.wav
        Protocols:
          MyDB:
            SpeakerDiarization:
              MyProtocol:
                train:
                  uri: train.lst
                  annotation: train.rttm
                  annotated: train.uem

    Relative paths are read from the file's directory.
    """
    path = Path(path)
    config = yaml_subset.load_file(path)
    root = path.parent

    def resolve(p):
        p = Path(str(p).replace("{uri}", "__URI__"))
        if not p.is_absolute():
            p = root / p
        return str(p).replace("__URI__", "{uri}")

    audio_templates = {db: resolve(tpl) for db, tpl in
                       (config.get("Databases") or {}).items()}

    for db, tasks in (config.get("Protocols") or {}).items():
        for task_name, protocols in tasks.items():
            for protocol_name, subsets in protocols.items():
                full_name = f"{db}.{task_name}.{protocol_name}"
                merged = Protocol(name=full_name)
                for subset, spec in subsets.items():
                    sub = Protocol.from_files(
                        db, rttm=resolve(spec["annotation"]),
                        lst=resolve(spec["uri"]) if "uri" in spec else None,
                        uem=resolve(spec["annotated"])
                        if "annotated" in spec else None,
                        subset=subset)
                    template = audio_templates.get(db)
                    if template:
                        for file in sub._subsets[subset]:
                            file["audio"] = template.format(uri=file["uri"])
                    merged = merged.merged_with(sub)
                merged.name = full_name
                _REGISTRY[full_name] = merged


def get_protocol(name: str) -> Protocol:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown protocol {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


class FileFinder:
    """A file's audio path from a template."""

    def __init__(self, template: str = "{uri}.wav"):
        self.template = template

    def __call__(self, file: Dict) -> str:
        return self.template.format(uri=file["uri"])
