"""Task base: the data side of training.

Counterpart of pyannote_audio_tpu/core/task.py. A task scans a protocol
into compact arrays (``prepare_data``: audio paths, structured per-file
metadata, usable annotated regions, annotation segments with file-,
database- and global-scope label indices; cached with
``np.savez_compressed``, so that a warm cache rebuilds the file tables
without reading the protocol), draws training chunks from a numpy
generator per (seed, worker, rank, epoch) (file by annotated duration,
region by duration, uniform start), collates them into numpy batches and
gives the loss of a model on a batch. Sampling is the JAX package's, draw
for draw: from the same protocol and seed both packages give the same
arrays.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Text,
                    Tuple, Union)

import numpy as np

from ..utils.database import Protocol
from .io import Audio
from .model import (Problem, Resolution,  # noqa: F401 re-export
                    Specifications, UnknownSpecificationsError)
from .segment import Segment


#: subset / scope vocabularies
Subsets = ("train", "development", "test")
Scopes = ("file", "database", "global")

#: file-dict keys that are handled structurally, not as free metadata
_RESERVED_KEYS = {"uri", "database", "subset", "audio", "scope", "classes",
                  "annotation", "annotated"}


def create_rng_for_worker(seed: int, epoch: int = 0, worker_id: int = 0,
                          rank: int = 0) -> np.random.Generator:
    """Deterministic per-(seed, worker, rank, epoch) numpy generator,
    seeded with the adler32 of the identity tuple."""
    identity = f"{seed}|{worker_id}|{rank}|{epoch}".encode()
    return np.random.default_rng(zlib.adler32(identity))


def get_dtype(value: int) -> str:
    """The smallest signed numpy dtype string ("b", "i2", "i" or "i8")
    that stores ``value``, as the JAX package sizes its compact
    prepared-data arrays."""
    for bound, dtype in ((127, "b"), (32_768, "i2"), (2_147_483_648, "i")):
        if bound > abs(value):
            return dtype
    return "i8"


@dataclass
class TrainingBatch:
    X: np.ndarray                       # (batch, channels, samples)
    y: Optional[np.ndarray] = None      # task-dependent target
    weight: Optional[np.ndarray] = None  # (batch, frames, 1) loss weight
    meta: Optional[Dict] = None


class TrainDataset:
    """Iterable view over a task's training chunks: prepared chunk dicts
    drawn with the task's worker-0 generator (``Task.train_batches`` is
    the collated path)."""

    def __init__(self, task: "Task", epoch: int = 0):
        self.task = task
        self.epoch = epoch

    def __iter__(self):
        rng = create_rng_for_worker(self.task.seed, epoch=self.epoch)
        for _ in range(len(self)):
            prepared = None
            while prepared is None:
                file, chunk = self.task.draw_chunk(rng)
                prepared = self.task.prepare_chunk(file, chunk, rng)
            yield prepared

    def __len__(self) -> int:
        return self.task.train__len__()


class ValDataset:
    """Indexable view over the fixed validation grid
    (``Task.prepare_validation``)."""

    def __init__(self, task: "Task"):
        self.task = task
        self._grid = task.prepare_validation()

    def __getitem__(self, idx: int) -> Dict:
        file, chunk = self._grid[idx]
        return self.task.prepare_chunk(file, chunk,
                                       np.random.default_rng(self.task.seed))

    def __len__(self) -> int:
        return len(self._grid)


class Task:
    """Base class for all tasks."""

    def __init__(
        self,
        protocol: Protocol,
        duration: float = 2.0,
        min_duration: Optional[float] = None,
        warm_up: Union[float, Tuple[float, float]] = 0.0,
        batch_size: int = 32,
        num_workers: Optional[int] = None,
        seed: int = 42,
        cache: Optional[str] = None,
        balance: Optional[Sequence[Text]] = None,
    ):
        self.protocol = protocol
        # metadata keys to balance chunks across: a group of files with
        # equal values is drawn uniformly first
        self.balance = list(balance) if balance else None
        self.duration = duration
        self.min_duration = duration if min_duration is None else min_duration
        if isinstance(warm_up, (int, float)):
            warm_up = (float(warm_up), float(warm_up))
        self.warm_up = warm_up
        self.batch_size = batch_size
        # > 1 enables the threaded input pipeline
        # (train_batches_parallel); None/0/1 prepare batches inline
        self.num_workers = num_workers
        self.seed = seed
        self.cache = cache or None
        self.audio = Audio(sample_rate=16000, mono="downmix")
        self._specifications: Optional[Specifications] = None
        self._prepared = False
        self._train_files: List[Dict] = []
        self._val_files: Optional[List[Dict]] = None
        self.prepared_data: Dict = {}
        self.model = None

    @property
    def has_validation(self) -> bool:
        return hasattr(self.protocol, "development")

    # -- metadata ----------------------------------------------------------

    def prepare_data(self) -> None:
        """Scan the protocol into compact ``prepared_data`` arrays.

        One pass over the train (and development) subsets gives numpy
        structured arrays: audio paths, per-file metadata (subset, scope,
        database and any extra str / int keys of the protocol), usable
        annotated regions, annotation segments with their file-,
        database- and global-scope label indices. With ``cache`` set they
        are written with ``np.savez_compressed``; a warm cache rebuilds
        the file tables with no protocol access (no audio header read, no
        annotation parsed). Under data parallelism every rank takes rank
        0's cache path (``parallel.broadcast_from_host0``, the reference's
        ``trainer.strategy.broadcast``); the call is unconditional, as a
        collective gated on a rank's own state would hang the group
        where ranks disagree, and without a process group it returns the
        path unchanged.
        """
        if self._prepared:
            return
        from ..parallel.mesh import broadcast_from_host0
        agreed = broadcast_from_host0(
            str(self.cache) if self.cache is not None else "")
        self.cache = agreed or None
        if self.cache is not None:
            from pathlib import Path
            cache_path = Path(self.cache)
            if cache_path.exists() and cache_path.stat().st_size > 0:
                prepared = _load_prepared_data(cache_path)
                if prepared is not None:  # None = stale/foreign format
                    # a cache built from another protocol must not be
                    # silently served
                    cached_name = prepared.get("protocol", "")
                    own_name = getattr(self.protocol, "name", "")
                    # one empty + one named is ALSO a mismatch: an
                    # unnamed protocol's cache served to a named one
                    # (or vice versa) is almost certainly foreign data
                    if (cached_name or own_name) and \
                            cached_name != own_name:
                        raise ValueError(
                            f"prepared-data cache {cache_path} was built "
                            f"from protocol {cached_name!r}, not "
                            f"{own_name!r}; delete it or use a "
                            f"different cache path")
                    self.prepared_data = prepared
                    self._train_files = _files_from_prepared(
                        prepared, "train")
                    self._val_files = _files_from_prepared(
                        prepared, "development") if self.has_validation \
                        else None
                    self._prepared = True
                    return

        subsets = [("train", self.protocol.train())]
        if self.has_validation:
            subsets.append(("development", self.protocol.development()))

        audios: List[str] = []
        uris: List[str] = []
        metadata_rows: List[Dict] = []
        metadata_values: Dict[str, List] = {
            "subset": list(Subsets), "scope": list(Scopes), "database": []}
        annotated_duration: List[float] = []
        regions: List[Tuple] = []          # (file_id, duration, start)
        regions_ids: List[Tuple[int, int]] = []
        raw_regions: List[Tuple] = []      # unfiltered annotated regions
        raw_regions_ids: List[Tuple[int, int]] = []
        segments: List[Tuple] = []         # 6-tuple rows
        segments_ids: List[Tuple[int, int]] = []
        file_labels: List[str] = []        # per-file label names, flat
        file_labels_ids: List[Tuple[int, int]] = []
        database_labels: Dict[str, List[str]] = {}
        global_labels: List[str] = []
        live_files: List[Tuple[str, Dict]] = []

        for file_id, (subset, file) in enumerate(
                (s, f) for s, it in subsets for f in it):
            database = file.get("database", "")
            if database not in metadata_values["database"]:
                metadata_values["database"].append(database)
            scope = file.get("scope", "file")
            row = {"subset": Subsets.index(subset),
                   "scope": Scopes.index(scope),
                   "database": metadata_values["database"].index(database)}
            for key in set(file) - _RESERVED_KEYS:
                value = file[key]
                if isinstance(value, (str, int, np.integer)):
                    # index-encode both str and int values: a uniform
                    # value table makes the warm-cache reconstruction
                    # exact for mixed / negative ints
                    if isinstance(value, (int, np.integer)):
                        value = int(value)
                    values = metadata_values.setdefault(key, [])
                    if value not in values:
                        values.append(value)
                    row[key] = values.index(value)
                # other types (waveform arrays, callables...) are kept on
                # the live dict but not cached
            metadata_rows.append(row)
            audios.append(str(file.get("audio", "")))
            uris.append(str(file.get("uri", "")))

            annotated = file.get("annotated")
            if annotated is None:
                raw_file_regions = \
                    [Segment(0, self.audio.get_duration(file))]
            else:
                raw_file_regions = list(annotated)
            # the region filter uses the FULL chunk duration
            # (min_duration only bounds the embedding task's
            # variable-length sampling, never the region filter).
            # A shorter region would make draw_chunk overrun into
            # un-annotated audio; the synthetic whole-file region above
            # gets the same filter (a 0.5 s file must not train as 75%
            # zero-padded negatives).
            file_regions = [s for s in raw_file_regions
                            if s.duration >= self.duration]
            r0 = len(regions)
            for seg in file_regions:
                regions.append((file_id, seg.duration, seg.start))
            regions_ids.append((r0, len(regions)))
            # the UNFILTERED annotated regions are persisted separately so
            # a warm-cache run rebuilds the same 'annotated' timeline a
            # cold run sees (short regions stay visible to consumers such
            # as whole-file weight slicing, only sampling ignores them)
            rr0 = len(raw_regions)
            for seg in raw_file_regions:
                raw_regions.append((file_id, seg.duration, seg.start))
            raw_regions_ids.append((rr0, len(raw_regions)))
            annotated_duration.append(
                sum(s.duration for s in file_regions))

            s0 = len(segments)
            l0 = len(file_labels)
            annotation = file.get("annotation")
            local: List[str] = []
            if annotation is not None:
                for seg, _, label in annotation.itertracks(
                        yield_label=True):
                    label = str(label)
                    if label not in local:
                        local.append(label)
                    db_idx = g_idx = -1
                    if scope in ("database", "global"):
                        db_list = database_labels.setdefault(database, [])
                        if label not in db_list:
                            db_list.append(label)
                        db_idx = db_list.index(label)
                    if scope == "global":
                        if label not in global_labels:
                            global_labels.append(label)
                        g_idx = global_labels.index(label)
                    segments.append((file_id, seg.start, seg.end,
                                     local.index(label), db_idx, g_idx))
            file_labels.extend(local)
            file_labels_ids.append((l0, len(file_labels)))
            segments_ids.append((s0, len(segments)))

            file = dict(file)
            if annotated is None:
                # cold/warm agreement: a warm cache rebuilds 'annotated'
                # from the raw-regions table, so a file without one gets
                # the synthetic whole-file timeline on the cold run too
                from ..core.annotation import Timeline
                file["annotated"] = Timeline(
                    raw_file_regions, uri=file.get("uri"))
            file["_regions"] = [Segment(s, s + d)
                                for _, d, s in regions[r0:len(regions)]]
            file["_annotated_duration"] = annotated_duration[-1]
            live_files.append((subset, file))

        self.prepared_data = {
            "protocol": getattr(self.protocol, "name", ""),
            "audio-path": np.array(audios, dtype=np.str_),
            "audio-uri": np.array(uris, dtype=np.str_),
            "audio-metadata": _structured(
                metadata_rows, list(metadata_values)),
            "audio-annotated": np.array(annotated_duration, np.float64),
            "annotations-regions": np.array(
                regions, dtype=[("file_id", "i4"), ("duration", "f8"),
                                ("start", "f8")]),
            "audio-regions-ids": np.array(
                regions_ids, dtype=[("start", "i4"), ("end", "i4")]),
            "annotations-raw-regions": np.array(
                raw_regions, dtype=[("file_id", "i4"), ("duration", "f8"),
                                    ("start", "f8")]),
            "audio-raw-regions-ids": np.array(
                raw_regions_ids, dtype=[("start", "i4"), ("end", "i4")]),
            "annotations-segments": np.array(
                segments, dtype=[("file_id", "i4"), ("start", "f8"),
                                 ("end", "f8"), ("file_label_idx", "i4"),
                                 ("database_label_idx", "i4"),
                                 ("global_label_idx", "i4")]),
            "audio-segments-ids": np.array(
                segments_ids, dtype=[("start", "i4"), ("end", "i4")]),
            "metadata-values": metadata_values,
            "metadata-labels": np.array(global_labels, dtype=np.str_),
            "metadata-file-labels": np.array(file_labels, dtype=np.str_),
            "audio-file-labels-ids": np.array(
                file_labels_ids, dtype=[("start", "i4"), ("end", "i4")]),
        }
        for database, labels in database_labels.items():
            self.prepared_data[f"metadata-{database}-labels"] = \
                np.array(labels, dtype=np.str_)

        self._train_files = [f for s, f in live_files if s == "train"
                             and f["_annotated_duration"] > 0]
        self._val_files = [f for s, f in live_files
                           if s == "development"] \
            if self.has_validation else None

        if self.cache is not None:
            from pathlib import Path
            cache_path = Path(self.cache)
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            if all(audios):  # in-memory waveforms can't persist
                _save_prepared_data(cache_path, self.prepared_data)
            else:
                import warnings
                warnings.warn(
                    f"prepared-data cache {cache_path} NOT written: some "
                    "files carry in-memory waveforms (no audio path), so "
                    "every run will rebuild from the protocol")
        self._prepared = True

    def setup(self, model=None) -> None:
        self.prepare_data()
        self.model = model

    @property
    def specifications(self) -> Union[Specifications,
                                      Tuple[Specifications, ...]]:
        if self._specifications is None:
            raise UnknownSpecificationsError(
                "Task has no specifications yet: call task.setup() first")
        return self._specifications

    @specifications.setter
    def specifications(self, value):
        self._specifications = value

    # -- sampling ----------------------------------------------------------

    def draw_chunk(self, rng: np.random.Generator) -> Tuple[Dict, Segment]:
        """File ∝ annotated duration, region ∝ duration, uniform start.

        With ``balance``, a metadata subgroup (e.g. per database) is drawn
        uniformly first, then a file within it.
        """
        candidates = self._train_files
        if not candidates:
            raise ValueError(
                "no trainable files: every annotated region is shorter "
                f"than the chunk duration ({self.duration:g} s) or has "
                "zero annotated duration — check the protocol or lower "
                "`duration`")
        if self.balance:
            groups: Dict[Tuple, List[Dict]] = {}
            for f in candidates:
                key = tuple(f.get(k) for k in self.balance)
                groups.setdefault(key, []).append(f)
            keys = sorted(groups, key=str)
            candidates = groups[keys[rng.integers(len(keys))]]
        weights = np.array([f["_annotated_duration"] for f in candidates])
        file = candidates[
            rng.choice(len(candidates), p=weights / weights.sum())]
        regions = file["_regions"]
        region_weights = np.array([r.duration for r in regions])
        region = regions[rng.choice(len(regions),
                                    p=region_weights / region_weights.sum())]
        start = region.start + rng.uniform() * \
            max(region.duration - self.duration, 0.0)
        return file, Segment(start, start + self.duration)

    def prepare_chunk(self, file: Dict, chunk: Segment,
                      rng: np.random.Generator) -> Dict:
        raise NotImplementedError

    def collate(self, chunks: List[Dict],
                rng: Optional[np.random.Generator] = None
                ) -> TrainingBatch:
        X = np.stack([c["X"] for c in chunks])
        y = np.stack([c["y"] for c in chunks]) if "y" in chunks[0] else None
        # some protocol files may lack the weight key: a mixed batch must
        # neither KeyError nor silently drop weighting — absent chunks
        # weigh 1.0 (neutral)
        if any("weight" in c for c in chunks):
            shape = next(c["weight"].shape for c in chunks
                         if "weight" in c)
            weight = np.stack([
                c["weight"] if "weight" in c
                else np.ones(shape, np.float32) for c in chunks])
        else:
            weight = None
        # registered batch augmentations; the per-epoch rng makes sub-1.0
        # `p` draws reproducible
        from ..augmentation.registry import apply_augmentations
        X, y = apply_augmentations(X, y, when="input", rng=rng)
        return TrainingBatch(X=X, y=y, weight=weight)

    def train_batches(self, epoch: int = 0, worker_id: int = 0,
                      rank: int = 0) -> Iterator[TrainingBatch]:
        """Infinite stream of training batches (bounded by train__len__)."""
        rng = create_rng_for_worker(self.seed, epoch=epoch,
                                    worker_id=worker_id, rank=rank)
        num_batches = max(1, self.train__len__() // self.batch_size)
        for _ in range(num_batches):
            chunks = []
            while len(chunks) < self.batch_size:
                file, chunk = self.draw_chunk(rng)
                prepared = self.prepare_chunk(file, chunk, rng)
                if prepared is not None:
                    chunks.append(prepared)
            yield self.collate(chunks, rng=rng)

    def train_batches_parallel(self, epoch: int = 0, rank: int = 0
                               ) -> Iterator[TrainingBatch]:
        """``train_batches`` prefetched on a producer thread.

        ``num_workers`` keeps a DataLoader's meaning for reproducibility:
        batch i comes from the per-(seed, worker = i % num_workers, epoch,
        rank) stream, so a (num_workers, seed) setup gives the same
        batches on every run. One thread merges the streams (chunk
        preparation is GIL-bound numpy, so more threads would only
        contend with the consumer's dispatch) and overlaps production
        with the device step; its errors are raised in the consumer.
        num_workers in (None, 0, 1) takes the inline path.
        """
        workers = self.num_workers or 0
        if workers <= 1:
            yield from self.train_batches(epoch=epoch, rank=rank)
            return
        import queue
        import threading

        num_batches = max(1, self.train__len__() // self.batch_size)
        # the bounded queue is the prefetch depth
        out_q: "queue.Queue" = queue.Queue(maxsize=max(2, workers))
        stop = threading.Event()

        def produce() -> None:
            def push(item) -> bool:
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                streams = [self.train_batches(epoch=epoch, worker_id=w,
                                              rank=rank)
                           for w in range(workers)]
                for i in range(num_batches):
                    if not push(next(streams[i % workers])):
                        return
            except BaseException as exc:  # noqa: BLE001 — re-raised in
                # the consumer: a dead producer must fail the training
                # run like the inline path would, not stall it forever
                push(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            for _ in range(num_batches):
                item = out_q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:                     # unblock a producer stuck on put()
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass

    def train__len__(self) -> int:
        """Chunks per epoch = total annotated duration / chunk duration."""
        total = sum(f["_annotated_duration"] for f in self._train_files)
        return max(self.batch_size,
                   math.floor(total / self.duration))

    # -- validation --------------------------------------------------------

    def prepare_validation(self) -> List[Tuple[Dict, Segment]]:
        """Fixed grid of validation chunks: each annotated region of each
        development file cut into whole chunks."""
        chunks: List[Tuple[Dict, Segment]] = []
        if not self.has_validation:
            return chunks          # protocol without a development subset
        if self._val_files is not None:
            val_files = self._val_files
        else:
            val_files = list(self.protocol.development())
        for file in val_files:
            if "_regions" in file:
                regions = file["_regions"]
            else:
                annotated = file.get("annotated")
                regions = list(annotated) if annotated is not None else \
                    [Segment(0, self.audio.get_duration(file))]
            for region in regions:
                if region.duration < self.duration:
                    continue
                num = int(region.duration // self.duration)
                for i in range(num):
                    start = region.start + i * self.duration
                    chunks.append(
                        (file, Segment(start, start + self.duration)))
        return chunks

    # -- loss --------------------------------------------------------------

    def loss(self, model, batch: TrainingBatch):
        """Scalar loss of ``model`` (an ``nn.Module``) on a batch of
        device tensors; implemented per task."""
        return self.loss_from_output(model(batch.X), batch)

    def loss_from_output(self, output, batch: TrainingBatch):
        """Scalar loss of a model's ``output`` on ``batch``."""
        raise NotImplementedError

    def loss_normalizer(self, batch: TrainingBatch) -> float:
        """What the loss of ``batch`` divides its sum by, up to a factor
        that is the same for every batch: the item count, for a loss that
        is a mean over items. Data-parallel training
        (``Trainer(mesh=)``) weighs each rank's loss by its share of the
        global sum, so that its averaged gradient is the global batch's;
        a task whose loss is normalised otherwise (by frame weights)
        overrides this."""
        return float(batch.X.shape[0])

    def validation_loss(self, model, output, batch: TrainingBatch):
        """The loss of a validation batch, given the validation forward's
        ``output`` (the first of a multi-task model's); a task whose loss
        needs more forwards (PixIT's mixtures of mixtures) runs them on
        ``model``."""
        return self.loss_from_output(output, batch)

    def augment_params(self, model, generator=None) -> Dict[str, Any]:
        """Task-owned trainable state (e.g. ArcFace prototypes) as
        {name: nn.Parameter}, trained beside the model's; none here."""
        return {}

    @property
    def val_monitor(self) -> Tuple[str, str]:
        return "loss/val", "min"

    # -- validation metrics ------------------------------------------------

    def default_metric(self):
        """Default validation metric(s): a metric, a sequence of them, or
        a {name: metric} dict; ``Trainer.validate`` computes its own
        family, this is for evaluation outside the trainer."""
        msg = f"Missing '{self.__class__.__name__}.default_metric' method."
        raise NotImplementedError(msg)

    @property
    def metric(self) -> Dict[str, Any]:
        """``default_metric`` as a {name: metric} dict, cached after the
        first access."""
        if getattr(self, "_metric", None) is None:
            metrics = self.default_metric()
            if isinstance(metrics, dict):
                self._metric = dict(metrics)
            elif isinstance(metrics, (list, tuple)):
                self._metric = {type(m).__name__: m for m in metrics}
            else:
                self._metric = {type(metrics).__name__: metrics}
        return self._metric


# -- prepared_data helpers ------------------------------------------------

def _structured(rows: List[Dict], keys: List[str]) -> np.ndarray:
    """Rows of {key: int} -> structured int array; missing keys -> -1."""
    dtype = [(key, "i4") for key in keys]
    data = [tuple(row.get(key, -1) for key in keys) for row in rows]
    return np.array(data, dtype=dtype)


def _save_prepared_data(path, prepared: Dict) -> None:
    """Atomic cache write: temp file + os.replace, so a process killed
    mid-write can never leave a truncated npz that poisons every
    subsequent run."""
    import json
    import os
    payload = dict(prepared)
    payload["metadata-values"] = np.array(
        json.dumps(payload["metadata-values"]), dtype=np.str_)
    payload["protocol"] = np.array(payload["protocol"], dtype=np.str_)
    # unique temp name: two jobs sharing one cache path (e.g. hosts of a
    # multi-host run on a shared filesystem) must not interleave writes
    # into a single .tmp — each publishes a complete copy atomically
    import uuid
    tmp = f"{path}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_prepared_data(path) -> Optional[Dict]:
    """Load a prepared-data npz; None if it isn't one (stale format) or
    is corrupt (truncated write from a killed process) — the caller then
    rebuilds and overwrites it."""
    import json
    import warnings
    import zipfile
    try:
        with np.load(path, allow_pickle=False) as z:
            if "audio-path" not in z.files \
                    or "metadata-values" not in z.files \
                    or "protocol" not in z.files:
                return None          # older cache layout: rebuild
            prepared = {name: z[name] for name in z.files}
        # decode INSIDE the guard: a structurally-valid zip with corrupt
        # payloads must also fall back to a rebuild, not crash
        prepared["metadata-values"] = json.loads(
            str(prepared["metadata-values"]))
        prepared["protocol"] = str(prepared["protocol"])
    except (zipfile.BadZipFile, OSError, ValueError, KeyError) as exc:
        warnings.warn(f"ignoring unreadable prepared-data cache "
                      f"{path}: {exc}")
        return None
    return prepared


def _files_from_prepared(prepared: Dict, subset: str) -> List[Dict]:
    """Rebuild live file dicts (annotation, annotated, regions) from the
    compact arrays — zero protocol/audio access on a warm cache."""
    from ..core.annotation import Annotation, Timeline
    values = prepared["metadata-values"]
    subset_idx = Subsets.index(subset)
    meta = prepared["audio-metadata"]
    extra_keys = [k for k in meta.dtype.names
                  if k not in ("subset", "scope", "database")]
    files: List[Dict] = []
    for file_id in range(len(prepared["audio-path"])):
        row = meta[file_id]
        if int(row["subset"]) != subset_idx:
            continue
        uri = str(prepared["audio-uri"][file_id]) or None
        r0, r1 = prepared["audio-regions-ids"][file_id]
        regions = [Segment(float(r["start"]),
                           float(r["start"]) + float(r["duration"]))
                   for r in prepared["annotations-regions"][r0:r1]]
        # 'annotated' comes from the UNFILTERED raw-regions table so warm
        # and cold runs agree for files with regions shorter than the
        # chunk duration; older caches without the table fall back to the
        # filtered set
        if "annotations-raw-regions" in prepared:
            rr0, rr1 = prepared["audio-raw-regions-ids"][file_id]
            annotated_regions = [
                Segment(float(r["start"]),
                        float(r["start"]) + float(r["duration"]))
                for r in prepared["annotations-raw-regions"][rr0:rr1]]
        else:
            annotated_regions = regions
        s0, s1 = prepared["audio-segments-ids"][file_id]
        l0, l1 = prepared["audio-file-labels-ids"][file_id]
        labels = [str(x) for x in prepared["metadata-file-labels"][l0:l1]]
        annotation = Annotation(uri=uri)
        for track, row_s in enumerate(
                prepared["annotations-segments"][s0:s1]):
            annotation[Segment(float(row_s["start"]), float(row_s["end"])),
                       track] = labels[int(row_s["file_label_idx"])]
        file: Dict = {
            "uri": uri,
            "audio": str(prepared["audio-path"][file_id]),
            "database": values["database"][int(row["database"])]
            if len(values["database"]) else "",
            "scope": Scopes[int(row["scope"])],
            "subset": subset,
            "annotation": annotation,
            "annotated": Timeline(annotated_regions, uri=uri),
            "_regions": regions,
            "_annotated_duration": float(
                prepared["audio-annotated"][file_id]),
        }
        for key in extra_keys:
            idx = int(row[key])
            if idx < 0:
                continue               # -1 = key absent for this file
            table = values.get(key, [])
            if idx < len(table):       # both str and int index-encoded
                file[key] = table[idx]
        if subset == "train" and file["_annotated_duration"] <= 0:
            continue
        files.append(file)
    return files
