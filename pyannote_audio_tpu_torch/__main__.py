"""Command-line interface: apply / benchmark / optimize / strip / export /
download / serve.

    python -m pyannote_audio_tpu_torch apply <pipeline dir> <wav or dir> \
        [--into <dir>] [--device cpu]

Counterpart of pyannote_audio_tpu/__main__.py, with the same commands,
arguments and outputs: per-file RTTM and JSON, a DER report (TXT and CSV,
per file and in total), ``speed.yml`` with seconds per audio-hour and
times faster than real time, a speaker-count confusion table, and
``optimize``'s resumable JSONL journal. What differs:

- ``--device``: "auto" (or no ``--device``) is the CUDA card, and the
  command fails without one; ``--device cpu`` is the only way to the
  CPU.
- ``benchmark --exact`` turns off the accelerator path's approximations
  (``PYANNOTE_TPU_SEG_BF16``, ``PYANNOTE_TPU_SHARED_SINC`` and
  ``PYANNOTE_TPU_SHARED_TRUNK`` set to "0").
- ``strip`` keeps what ``Model.from_pretrained`` reads (``config.yaml``,
  ``pytorch_model.bin``) and drops trainer state; ``export`` rewrites a
  checkpoint as a plain reference checkpoint (``utils/convert.py``
  ``write_reference_checkpoint``), which both packages read.
- A pipeline argument may be a hub id, resolved as the JAX package
  resolves it (``utils/hf_hub.py``: the ``PYANNOTE_TPU_HUB`` roots, the
  download cache, then ``HF_ENDPOINT``); ``download`` loads one for
  later offline use, with the JAX CLI's ``token``, ``--revision`` and
  ``--cache``.

YAML (configs, registries, reports) goes through ``utils/yaml_subset.py``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import threading
import time
from enum import Enum
from functools import partial
from pathlib import Path
from typing import Optional

import torch

from .utils import yaml_subset


class Metric(str, Enum):
    DiarizationErrorRate = "DiarizationErrorRate"
    JaccardErrorRate = "JaccardErrorRate"

    @classmethod
    def from_str(cls, metric: str, collar: float = 0.0,
                 skip_overlap: bool = False):
        """String -> accumulating metric instance."""
        from .metrics.der import DiarizationErrorRate, JaccardErrorRate
        if metric == "DiarizationErrorRate":
            return DiarizationErrorRate(collar=collar,
                                        skip_overlap=skip_overlap)
        if metric == "JaccardErrorRate":
            return JaccardErrorRate(collar=collar,
                                    skip_overlap=skip_overlap)
        raise ValueError(f"unknown metric {metric!r}")


def parse_device(device: Optional[str] = None) -> torch.device:
    """None or "auto" -> the CUDA card, which must be there; "cpu",
    "cuda" or "cuda:N" as given (a CUDA device without a card raises)."""
    from .utils.runtime import check_device
    return check_device(None if device in (None, "auto") else device)


def get_diarization(prediction):
    """The speaker-diarization Annotation of a pipeline output."""
    from .core.annotation import Annotation
    if isinstance(prediction, Annotation):
        return prediction
    if hasattr(prediction, "speaker_diarization"):
        return prediction.speaker_diarization
    raise ValueError(
        f"cannot extract a diarization from {type(prediction).__name__}: "
        "expected an Annotation or an object with a .speaker_diarization")


class MinDurationOffOptimizer:
    """Find the best ``min_duration_off`` collar after the fact:
    ``support(collar)`` fills within-speaker gaps, a bounded scalar
    minimization searches the collar with a forced no-collar baseline,
    and each file dict keeps its best post-processed diarization as
    ``best_speaker_diarization``."""

    def _compute_metric(self, files, metric, collar: float) -> float:
        metric.reset()
        for file in files:
            file["temporary_speaker_diarization"] = \
                file["speaker_diarization"].support(collar=collar)
            metric(file["annotation"],
                   file["temporary_speaker_diarization"],
                   uem=file.get("annotated"))
        self._reports[collar] = metric.report()
        current = abs(metric)
        if current < self._best_metric:
            self._best_metric = current
            for file in files:
                file["best_speaker_diarization"] = file.pop(
                    "temporary_speaker_diarization")
        return current

    def __call__(self, files, metric, bounds=(0.0, 1.0)):
        from scipy.optimize import minimize_scalar

        self._best_metric = float("inf")
        self._reports = {}
        no_collar = self._compute_metric(files, metric, 0.0)
        res = minimize_scalar(partial(self._compute_metric, files, metric),
                              bounds=bounds, method="Bounded")
        best = 0.0 if no_collar == self._best_metric else float(res.x)
        return best, self._reports[best]


def _load_pipeline(pipeline_path: str, device: Optional[str] = None,
                   **hub):
    """The pipeline of a snapshot (directory or ``config.yaml``) or a hub
    id on ``parse_device(device)``; ``hub`` holds ``token`` and
    ``revision``."""
    from .core.pipeline import Pipeline
    device = parse_device(device)
    return Pipeline.from_pretrained(pipeline_path, device=device,
                                    **hub).to(device)


def _audio_files(path: Path):
    if path.is_dir():
        return sorted(p for p in path.rglob("*.wav"))
    return [path]


def cmd_apply(args) -> int:
    """Apply a pipeline to an audio file or a directory of WAV files;
    write RTTM and JSON. Several files go through the pipelined batch
    apply."""
    pipeline = _load_pipeline(args.pipeline, device=args.device)
    into = Path(args.into) if args.into else None
    if into:
        into.mkdir(parents=True, exist_ok=True)
    audios = list(_audio_files(Path(args.audio)))
    stems = [a.stem for a in audios]
    if len(audios) > 1 and len(set(stems)) == len(stems):
        outputs = pipeline([str(a) for a in audios])
    else:
        # equal stems (one name in two subdirectories) would share a uri
        # in the batch: those run one after another
        outputs = [pipeline(str(a)) for a in audios]
    for audio, output in zip(audios, outputs):
        annotation = getattr(output, "speaker_diarization", output)
        if into:
            with open(into / f"{audio.stem}.rttm", "w") as f:
                annotation.write_rttm(f)
            if hasattr(output, "serialize"):
                with open(into / f"{audio.stem}.json", "w") as f:
                    json.dump(output.serialize(), f, indent=2)
        else:
            annotation.write_rttm(sys.stdout)
    return 0


EXACT_GATES = ("PYANNOTE_TPU_SEG_BF16", "PYANNOTE_TPU_SHARED_SINC",
               "PYANNOTE_TPU_SHARED_TRUNK")


def cmd_benchmark(args) -> int:
    """Evaluate a pipeline on a protocol subset; report DER and speed."""
    if getattr(args, "exact", False):
        for name in EXACT_GATES:
            os.environ[name] = "0"

    from .core.io import Audio
    from .metrics.der import DiarizationErrorRate
    from .utils.database import get_protocol, register_database

    if args.registry:
        register_database(args.registry)
    pipeline = _load_pipeline(args.pipeline, device=args.device)
    protocol = get_protocol(args.protocol)
    into = Path(args.into)
    into.mkdir(parents=True, exist_ok=True)

    metric = DiarizationErrorRate(collar=args.collar,
                                  skip_overlap=args.skip_overlap)
    audio = Audio()
    rows = []
    total_audio = 0.0
    total_wall = 0.0
    confusion = {}
    progress_hook = None
    if getattr(args, "progress", False):
        from .pipelines.utils.hook import ProgressHook
        progress_hook = ProgressHook()
    for file in getattr(protocol, args.subset)():
        t0 = time.perf_counter()
        kwargs = {}
        if progress_hook is not None:
            kwargs["hook"] = progress_hook
        if args.num_speakers == "oracle" and "annotation" in file:
            kwargs["num_speakers"] = len(file["annotation"].labels())
        output = pipeline(file, **kwargs)
        wall = time.perf_counter() - t0
        hypothesis = getattr(output, "speaker_diarization", output)
        with open(into / f"{file['uri']}.rttm", "w") as f:
            hypothesis.write_rttm(f)
        if hasattr(output, "serialize"):
            with open(into / f"{file['uri']}.json", "w") as f:
                json.dump(output.serialize(), f, indent=2)
        der = metric(file["annotation"], hypothesis,
                     uem=file.get("annotated"), detailed=True)
        duration = audio.get_duration(file)
        total_audio += duration
        total_wall += wall
        n_ref = len(file["annotation"].labels())
        n_hyp = len(hypothesis.labels())
        confusion[(n_ref, n_hyp)] = confusion.get((n_ref, n_hyp), 0) + 1
        rows.append({"uri": file["uri"], **der,
                     "wall_seconds": round(wall, 3)})
        print(f"{file['uri']}: DER="
              f"{der['diarization error rate']:.2%} ({wall:.1f}s)")

    if getattr(args, "optimize_min_duration_off", False):
        from .utils.rttm import load_rttm
        opt_files = []
        for file in getattr(protocol, args.subset)():
            hyp = load_rttm(into / f"{file['uri']}.rttm").get(file["uri"])
            if hyp is not None:
                opt_files.append({"annotation": file["annotation"],
                                  "annotated": file.get("annotated"),
                                  "speaker_diarization": hyp})
        optimizer = MinDurationOffOptimizer()
        best_collar, best_report = optimizer(
            opt_files, DiarizationErrorRate(collar=args.collar,
                                            skip_overlap=args.skip_overlap))
        best_der = best_report["diarization error rate"]
        print(f"optimal min_duration_off = {best_collar:.2f} "
              f"(DER {best_der:.2%})")
        yaml_subset.dump_file({"min_duration_off": float(best_collar),
                               "der": float(best_der)},
                              into / "min_duration_off.yml")

    report = metric.report()
    seconds_per_hour = total_wall / (total_audio / 3600.0) \
        if total_audio else float("nan")
    speed = {
        "seconds_per_hour": round(seconds_per_hour, 1),
        "times_faster_than_realtime": round(
            total_audio / total_wall, 1) if total_wall else None,
    }
    yaml_subset.dump_file(speed, into / "speed.yml")
    with open(into / "metric.txt", "w") as f:
        f.write(f"DER = {report['diarization error rate']:.2%}\n")
        for k in ("false alarm", "missed detection", "confusion", "total"):
            f.write(f"{k} = {report[k]:.1f}s\n")
    with open(into / "metric.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    with open(into / "speaker_count_confusion.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["reference", "hypothesis", "count"])
        for (r, h), c in sorted(confusion.items()):
            writer.writerow([r, h, c])
    print(f"\nDER = {report['diarization error rate']:.2%}  "
          f"({seconds_per_hour:.1f}s per audio-hour)")
    return 0


def cmd_optimize(args) -> int:
    """TPE search of the pipeline's hyperparameters, resumable from its
    JSONL journal, starting from the pipeline's current parameters. Each
    file is one dict for every trial and the pipeline is in training
    mode, so its segmentation and embeddings are computed once and reused
    while the trials' hyperparameters leave them valid."""
    from .core.optimizer import Optimizer, TPESampler
    from .utils.database import get_protocol, register_database

    if args.registry:
        register_database(args.registry)
    pipeline = _load_pipeline(args.pipeline,
                              device=getattr(args, "device", None))
    protocol = get_protocol(args.protocol)
    # the training caches live in these dicts: copies per trial would
    # defeat them
    files = [dict(file) for file in getattr(protocol, args.subset)()]
    journal = Path(args.into) / "journal.jsonl"

    warm_start = None
    try:
        warm_start = dict(pipeline.parameters(instantiated=True))
    except (RuntimeError, NotImplementedError, KeyError):
        pass

    optimizer = Optimizer(pipeline.parameters(), journal=journal,
                          sampler=TPESampler(seed=args.seed),
                          warm_start=warm_start)

    was_training = pipeline.training
    pipeline.training = True
    try:
        metric_name = getattr(args, "metric", None) \
            or "DiarizationErrorRate"

        def objective_fn(params) -> float:
            pipeline.instantiate(params)
            metric = Metric.from_str(metric_name)
            for file in files:
                output = pipeline(file)
                metric(file["annotation"], get_diarization(output),
                       uem=file.get("annotated"))
            return abs(metric)

        for trial_idx, params in zip(
                range(len(optimizer.history),
                      len(optimizer.history) + args.trials),
                optimizer.suggestions(args.trials)):
            objective = objective_fn(params)
            optimizer.tell(params, objective)
            print(f"trial {trial_idx}: {objective:.4f} "
                  f"(best {optimizer.best[1]:.4f})")
    finally:
        pipeline.training = was_training

    best_params, best_objective = optimizer.best
    print(json.dumps({"best_params": best_params,
                      "best_objective": best_objective}, indent=2))
    return 0


# what Model.from_pretrained and Pipeline.from_pretrained read; trainer
# state (train_state.pt) and anything else stays behind
STRIPPED_FILES = ("config.yaml", "pytorch_model.bin")


def cmd_strip(args) -> int:
    """Copy a checkpoint directory's inference files only."""
    src, dst = Path(args.checkpoint), Path(args.into)
    names = [name for name in STRIPPED_FILES if (src / name).exists()]
    if not names:
        raise SystemExit(f"{src} does not look like a checkpoint dir")
    dst.mkdir(parents=True, exist_ok=True)
    for name in names:
        shutil.copy(src / name, dst / name)
    print(f"stripped checkpoint written to {dst}")
    return 0


def cmd_export(args) -> int:
    """Rewrite a checkpoint (a directory or ``pytorch_model.bin`` that
    ``Model.from_pretrained`` reads) as a plain reference checkpoint."""
    from .core.model import Model
    from .train.trainer import save_checkpoint
    try:
        model = Model.from_pretrained(args.checkpoint)
    except ValueError as error:
        print(error)
        return 1
    path = save_checkpoint(model, args.into)
    print(f"reference checkpoint written to {path}")
    return 0


def cmd_serve(args) -> int:
    """Serve a pipeline over the pyannoteAI-shaped REST API."""
    from .serve import DiarizationServer
    pipeline = _load_pipeline(args.pipeline, device=args.device)
    server = DiarizationServer(pipeline, host=args.host, port=args.port,
                               token=args.token)
    server.start()
    print(f"serving {args.pipeline} at {server.api_url} (Ctrl-C to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        print("shutting down")
        server.shutdown()
    return 0


def cmd_download(args) -> int:
    """Load a pretrained pipeline (a hub id's files into the download
    cache, ``--cache`` or ``PYANNOTE_TPU_CACHE``) for later offline use,
    on ``--device`` (the card by default)."""
    if args.cache:
        os.environ["PYANNOTE_TPU_CACHE"] = args.cache
    try:
        pipeline = _load_pipeline(args.model, device=args.device,
                                  revision=args.revision, token=args.token)
    except (ValueError, FileNotFoundError, OSError) as error:
        print(f"Could not load pretrained pipeline from {args.model}: "
              f"{error}")
        return 1
    print(f"downloaded {args.model} ({type(pipeline).__name__})")
    return 0


# -- the commands as functions -------------------------------------------------

def apply(pipeline: str, audio: str, into: Optional[str] = None,
          device: Optional[str] = None) -> int:
    return cmd_apply(argparse.Namespace(
        pipeline=pipeline, audio=audio, into=into, device=device))


def benchmark(pipeline: str, protocol: str, into: str,
              registry: Optional[str] = None, subset: str = "test",
              collar: float = 0.0, skip_overlap: bool = False,
              num_speakers: Optional[str] = None, exact: bool = False,
              optimize_min_duration_off: bool = False,
              progress: bool = False,
              device: Optional[str] = None) -> int:
    return cmd_benchmark(argparse.Namespace(
        pipeline=pipeline, protocol=protocol, into=into, registry=registry,
        subset=subset, collar=collar, skip_overlap=skip_overlap,
        num_speakers=num_speakers, exact=exact,
        optimize_min_duration_off=optimize_min_duration_off,
        progress=progress, device=device))


def optimize(pipeline: str, protocol: str, into: str,
             registry: Optional[str] = None, subset: str = "development",
             trials: int = 20, seed: int = 42,
             metric: str = "DiarizationErrorRate",
             device: Optional[str] = None) -> int:
    return cmd_optimize(argparse.Namespace(
        pipeline=pipeline, protocol=protocol, into=into, registry=registry,
        subset=subset, trials=trials, seed=seed, metric=metric,
        device=device))


def strip(checkpoint: str, into: str) -> int:
    return cmd_strip(argparse.Namespace(checkpoint=checkpoint, into=into))


def download(model: str, token: Optional[str] = None,
             revision: Optional[str] = None, cache: Optional[str] = None,
             device: Optional[str] = None) -> int:
    return cmd_download(argparse.Namespace(
        model=model, token=token, revision=revision, cache=cache,
        device=device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pyannote_audio_tpu_torch",
        description="speaker diarization on a CUDA card")
    sub = parser.add_subparsers(dest="command", required=True)
    device_help = "cpu, cuda[:N] or auto (the CUDA card; the default)"

    p_apply = sub.add_parser("apply", help="apply pipeline to audio")
    p_apply.add_argument("pipeline")
    p_apply.add_argument("audio")
    p_apply.add_argument("--into", default=None)
    p_apply.add_argument("--device", default=None, help=device_help)
    p_apply.set_defaults(fn=cmd_apply)

    p_bench = sub.add_parser("benchmark", help="evaluate on a protocol")
    p_bench.add_argument("pipeline")
    p_bench.add_argument("protocol")
    p_bench.add_argument("into")
    p_bench.add_argument("--registry", default=None,
                         help="path to database.yml")
    p_bench.add_argument("--subset", default="test")
    p_bench.add_argument("--collar", type=float, default=0.0)
    p_bench.add_argument("--skip-overlap", action="store_true")
    p_bench.add_argument("--num-speakers", default=None,
                         choices=[None, "oracle"], nargs="?")
    p_bench.add_argument("--exact", action="store_true",
                         help="float32 SincNet, per-chunk sinc front-end "
                              "and trunk (the exact path)")
    p_bench.add_argument("--optimize-min-duration-off",
                         action="store_true")
    p_bench.add_argument("--progress", action="store_true",
                         help="show per-stage progress (ProgressHook)")
    p_bench.add_argument("--device", default=None, help=device_help)
    p_bench.set_defaults(fn=cmd_benchmark)

    p_opt = sub.add_parser("optimize", help="tune hyperparameters")
    p_opt.add_argument("pipeline")
    p_opt.add_argument("protocol")
    p_opt.add_argument("into")
    p_opt.add_argument("--registry", default=None)
    p_opt.add_argument("--subset", default="development")
    p_opt.add_argument("--trials", type=int, default=20)
    p_opt.add_argument("--seed", type=int, default=42)
    p_opt.add_argument("--metric", default="DiarizationErrorRate",
                       choices=[m.value for m in Metric],
                       help="metric to optimize against")
    p_opt.add_argument("--device", default=None, help=device_help)
    p_opt.set_defaults(fn=cmd_optimize)

    p_strip = sub.add_parser("strip", help="slim checkpoint")
    p_strip.add_argument("checkpoint")
    p_strip.add_argument("into")
    p_strip.set_defaults(fn=cmd_strip)

    p_exp = sub.add_parser(
        "export", help="write a plain reference-format torch checkpoint")
    p_exp.add_argument("checkpoint", help="checkpoint directory or file")
    p_exp.add_argument("into", help="output directory or .bin path")
    p_exp.set_defaults(fn=cmd_export)

    p_srv = sub.add_parser(
        "serve", help="REST serving (pyannoteAI-shaped API)")
    p_srv.add_argument("pipeline")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8046)
    p_srv.add_argument("--token", default=None)
    p_srv.add_argument("--device", default=None, help=device_help)
    p_srv.set_defaults(fn=cmd_serve)

    p_dl = sub.add_parser(
        "download", help="cache a pretrained pipeline for offline use")
    p_dl.add_argument("model", help="a hub id, a local snapshot directory "
                                    "or config.yaml")
    p_dl.add_argument("token", nargs="?", default=None,
                      help="Huggingface token")
    p_dl.add_argument("--revision", default=None)
    p_dl.add_argument("--cache", default=None,
                      help="download cache directory "
                           "(default: PYANNOTE_TPU_CACHE)")
    p_dl.add_argument("--device", default=None, help=device_help)
    p_dl.set_defaults(fn=cmd_download)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
