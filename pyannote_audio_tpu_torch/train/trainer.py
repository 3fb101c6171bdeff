"""The training loop: a model, a task, Adam, epochs.

Counterpart of pyannote_audio_tpu/train/trainer.py, with its semantics:

- Adam (``torch.optim.Adam`` for optax's ``adam``) at ``learning_rate``,
  or the optimizer a factory builds from the (name, parameter) pairs
  (``tasks.separation.pixit_optimizer`` routes WavLM's by name); with
  ``gradient_clip_val`` (the trainer's, then the optimizer's own
  ``gradient_clip_val`` attribute where it has one) the gradients are
  clipped first by their global norm, with optax's
  ``clip_by_global_norm`` formula.
- Frozen prefixes (``trainer.frozen_prefixes``, seeded from the model's
  ``frozen_modules`` and set by callbacks such as ``GraduallyUnfreeze``)
  zero a parameter's update only: it stays in the optimizer and its
  moments advance, as under the JAX package's update mask.
- A batch whose loss is not finite leaves the parameters and the
  optimizer state as they were: both are copied before the step and
  selected back with ``torch.where`` on the device, with no host sync.
  Losses stay on the device and are read once per epoch.
- Batches upload from page-locked memory (``core.inference.to_device``):
  X and weights as float32, integer targets (class indices) as they are.
- BatchNorm normalises by its running statistics in training too, and
  they stay as they are: the JAX trainer never runs its modules in train
  mode. (Its Adam steps the running statistics as parameters, having
  them in the differentiated tree; the port keeps them out of the
  optimizer.) The model runs as it serves on its
  device: on a CUDA card the LSTM kernel in the forward
  (``ops.lstm_kernel.LSTMRecurrence``) and bf16 SincNet under
  ``PYANNOTE_TPU_SEG_BF16``; the backward runs with TF32 off.
- ``validate`` runs the full fixed validation grid (or
  ``limit_val_chunks`` chunks, strided) through one forward per batch:
  ``loss/val``, ``der/val`` and its components, ``der/val/optimal`` and
  its threshold for powerset tasks, ``auroc/val`` for the others.
- ``log_dir`` gets ``metrics.jsonl`` and, every 2^n epochs, a figure of
  the first validation batch (matplotlib, imported then).
- ``checkpoint_dir`` gets ``epoch_N`` and ``best`` as reference-layout
  checkpoints (``Model.from_pretrained`` reads them) and, beside each
  epoch's, an atomic ``train_state.pt`` (model and optimizer state,
  epoch, best score, epochs since best, best epoch), from which
  ``fit(resume_from=)`` continues the trajectory exactly.
- Early stopping on ``monitor`` (the task's ``val_monitor`` by default);
  without it in the record, the train loss in min direction, decided
  once per fit.

It runs on one device: the CUDA card unless ``device`` says otherwise
(``"cpu"``); without a card it raises. ``mesh`` (data parallelism over
several cards) is not taken yet.
"""

from __future__ import annotations

import json
import math
import os
import time
import uuid
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.inference import to_device
from ..core.model import attach_specifications, is_frozen
from ..core.task import Task, TrainingBatch
from ..utils.runtime import check_device, exact_float32

TRAIN_STATE = "train_state.pt"


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: where the global L2
    norm of ``grads`` is at least ``max_norm``, each becomes
    ``g / norm * max_norm``; below it they are kept."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _state_tensors(optimizer: torch.optim.Optimizer, params):
    """(state dict, key) of every tensor in the optimizer's state of
    ``params``, state created by the first step included."""
    return [(optimizer.state[p], key) for p in params
            for key, value in optimizer.state[p].items()
            if isinstance(value, torch.Tensor)]


class Trainer:
    """Epoch-driven training loop on one device."""

    def __init__(
        self,
        max_epochs: int = 1,
        limit_train_batches: Optional[int] = None,
        learning_rate: float = 1e-3,
        optimizer: Optional[Callable[
            [List[Tuple[str, torch.nn.Parameter]]],
            torch.optim.Optimizer]] = None,
        mesh: Optional[Any] = None,
        checkpoint_dir: Optional[Union[str, Path]] = None,
        gradient_clip_val: Optional[float] = None,
        callbacks: Optional[List] = None,
        seed: int = 42,
        log_dir: Optional[Union[str, Path]] = None,
        monitor: Optional[Tuple[str, str]] = None,
        early_stopping_patience: Optional[int] = None,
        limit_val_chunks: Optional[int] = None,
        device: Union[str, torch.device, None] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) is not ported yet: data parallelism over "
                "several cards waits on ROADMAP.md §1's DDP item")
        self.device = check_device(device)
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.learning_rate = learning_rate
        self.optimizer_factory = optimizer
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir \
            else None
        self.gradient_clip_val = gradient_clip_val
        self.callbacks = callbacks or []
        self.seed = seed
        self.log_dir = Path(log_dir) if log_dir else None
        self.monitor = monitor
        self.early_stopping_patience = early_stopping_patience
        self.limit_val_chunks = limit_val_chunks
        self.history: List[Dict] = []
        self.best_epoch: Optional[int] = None
        self.frozen_prefixes: Tuple[str, ...] = ()
        #: per training step: (epoch, host seconds waiting for the batch,
        #: host seconds queueing the step, device ms of the step (CUDA
        #: events; None on the CPU))
        self.step_timings: List[Tuple[int, float, float,
                                      Optional[float]]] = []

    def make_optimizer(self, params: List[torch.nn.Parameter],
                       names: Optional[List[str]] = None
                       ) -> torch.optim.Optimizer:
        """The factory's optimizer over the (name, parameter) pairs, or
        Adam at ``learning_rate`` over ``params``."""
        if self.optimizer_factory is not None:
            names = names or [str(i) for i in range(len(params))]
            return self.optimizer_factory(list(zip(names, params)))
        # capturable keeps Adam's step count on the card, so that the
        # non-finite skip selects it there too
        return torch.optim.Adam(params, lr=self.learning_rate,
                                capturable=self.device.type == "cuda")

    def fit(self, model: torch.nn.Module, task: Optional[Task] = None,
            resume_from: Optional[Union[str, Path]] = None
            ) -> torch.nn.Module:
        """Train ``model`` (an ``nn.Module``, trained in place and moved
        to the trainer's device) on ``task``. ``resume_from`` is an epoch
        checkpoint directory of an earlier fit (``checkpoint_dir /
        epoch_N``): its ``train_state.pt`` restores parameters, task
        state, optimizer state, epoch and the early-stopping bookkeeping.
        """
        task = task or getattr(model, "task", None)
        if task is None:
            raise ValueError("no task to fit on")
        generator = torch.Generator().manual_seed(self.seed)
        task.setup(model)
        attach_specifications(model, task.specifications, generator)
        model.to(self.device)
        model.task = task
        task_params = {
            name: torch.nn.Parameter(p.detach().to(self.device))
            for name, p in task.augment_params(model, generator).items()}
        names = [name for name, _ in model.named_parameters()] \
            + [f"task.{name}" for name in task_params]
        params = list(model.parameters()) + list(task_params.values())
        optimizer = self.make_optimizer(params, names)
        start_epoch = 0
        best_score, epochs_since_best = math.inf, 0
        if resume_from is not None:
            state = torch.load(Path(resume_from) / TRAIN_STATE,
                               map_location=self.device, weights_only=True)
            model.load_state_dict(state["model"])
            with torch.no_grad():
                for name, p in task_params.items():
                    p.copy_(state["task"][name])
            optimizer.load_state_dict(state["optimizer"])
            start_epoch = int(state["epoch"]) + 1
            best_score = float(state["best_score"])
            epochs_since_best = int(state["epochs_since_best"])
            self.best_epoch = state["best_epoch"]
        self.frozen_prefixes = tuple(getattr(model, "frozen_modules", ()))
        task.trainable_params = task_params
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_start"):
                cb.on_fit_start(self, model)
        monitor_name, monitor_mode = self.monitor or task.val_monitor
        sign = 1.0 if monitor_mode == "min" else -1.0
        monitor_key = None      # decided once per fit, at the first epoch
        for epoch in range(start_epoch, self.max_epochs):
            for cb in self.callbacks:
                if hasattr(cb, "on_train_epoch_start"):
                    cb.on_train_epoch_start(self, model, epoch)
            frozen = [is_frozen(name, self.frozen_prefixes)
                      for name in names]
            record = {"epoch": epoch,
                      "loss": self._train_epoch(model, task, optimizer,
                                                params, frozen, epoch)}
            record.update(self.validate(model, task,
                                        max_chunks=self.limit_val_chunks,
                                        epoch=epoch))
            self.history.append(record)
            if self.log_dir is not None:
                self.log_dir.mkdir(parents=True, exist_ok=True)
                with open(self.log_dir / "metrics.jsonl", "a") as f:
                    f.write(json.dumps(
                        {k: (None if isinstance(v, float) and math.isnan(v)
                             else v) for k, v in record.items()}) + "\n")
            if self.checkpoint_dir is not None:
                save_checkpoint(model, self.checkpoint_dir
                                / f"epoch_{epoch}")
            # best checkpoint and early stopping on the monitored metric;
            # without it (no validation), the train loss in min direction
            if monitor_key is None:
                monitor_key = monitor_name if monitor_name in record \
                    else "loss"
            effective_sign = 1.0 if monitor_key == "loss" \
                and monitor_name != "loss" else sign
            score = record.get(monitor_key)
            if score is not None and not math.isnan(float(score)) and \
                    effective_sign * float(score) < best_score:
                best_score = effective_sign * float(score)
                epochs_since_best = 0
                self.best_epoch = epoch
                if self.checkpoint_dir is not None:
                    save_checkpoint(model, self.checkpoint_dir / "best")
            else:
                # a NaN or missing score is no improvement: a diverged
                # run still stops early
                epochs_since_best += 1
            if self.checkpoint_dir is not None:
                _save_atomic({
                    "model": model.state_dict(),
                    "task": {k: v.detach() for k, v in task_params.items()},
                    "optimizer": optimizer.state_dict(), "epoch": epoch,
                    "best_score": best_score,
                    "epochs_since_best": epochs_since_best,
                    "best_epoch": self.best_epoch},
                    self.checkpoint_dir / f"epoch_{epoch}" / TRAIN_STATE)
            if self.early_stopping_patience is not None and \
                    epochs_since_best >= self.early_stopping_patience:
                break
        model.eval()
        return model

    def _train_epoch(self, model, task, optimizer, params, frozen,
                     epoch: int) -> float:
        """One epoch of steps; returns the mean finite loss (NaN if
        none)."""
        train_mode(model)
        losses = []
        events = []
        batches = iter(task.train_batches_parallel(epoch=epoch))
        while self.limit_train_batches is None or \
                len(losses) < self.limit_train_batches:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            pair = None
            if self.device.type == "cuda":
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
            losses.append(self.train_step(model, task, optimizer, params,
                                          frozen, self.to_device(batch)))
            if pair is not None:
                pair[1].record()
            events.append(pair)
            self.step_timings.append(
                (epoch, t1 - t0, time.perf_counter() - t1, None))
        batches.close()
        # the epoch's one host read of the device
        values = torch.stack(losses).cpu().numpy() if losses \
            else np.zeros(0)
        first = len(self.step_timings) - len(events)
        for k, pair in enumerate(events):
            if pair is not None:
                self.step_timings[first + k] = \
                    self.step_timings[first + k][:3] \
                    + (pair[0].elapsed_time(pair[1]),)
        finite = values[np.isfinite(values)]
        if len(finite) < len(values):
            bad = np.nonzero(~np.isfinite(values))[0]
            warnings.warn(
                f"skipped {len(bad)} batch(es) of epoch {epoch} with "
                f"non-finite loss (indices {bad.tolist()})")
        return float(np.mean(finite)) if len(finite) else math.nan

    def to_device(self, batch: TrainingBatch) -> TrainingBatch:
        """A host batch on the trainer's device: X and weight as float32,
        y as float32 unless it holds integers (class indices), meta as
        given (``core.inference.to_device``)."""
        def put(value, dtype=None):
            if value is None:
                return None
            return to_device(np.asarray(value, dtype), self.device)
        integer = batch.y is not None and np.issubdtype(
            np.asarray(batch.y).dtype, np.integer)
        return TrainingBatch(
            X=put(batch.X, np.float32),
            y=put(batch.y, None if integer else np.float32),
            weight=put(batch.weight, np.float32),
            meta=None if batch.meta is None else {
                k: put(v) for k, v in batch.meta.items()})

    def train_step(self, model, task, optimizer, params, frozen,
                   batch: TrainingBatch) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (a
        device scalar). Queues work only: nothing here waits for the
        device."""
        optimizer.zero_grad(set_to_none=True)
        loss = task.loss(model, batch)
        with exact_float32():
            loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in params if p.grad is not None]
            for clip in (self.gradient_clip_val,
                         getattr(optimizer, "gradient_clip_val", None)):
                if clip:
                    clip_by_global_norm(grads, clip)
            old = [p.detach().clone() for p in params]
            state = _state_tensors(optimizer, params)
            old_state = [s[k].clone() for s, k in state]
            optimizer.step()
            good = torch.isfinite(loss.detach())
            for p, before, freeze in zip(params, old, frozen):
                p.copy_(torch.where(good, before if freeze else p, before))
            # state that the first step created starts from zeros
            seen = {(id(s), k) for s, k in state}
            for (s, k), before in zip(state, old_state):
                s[k].copy_(torch.where(good.to(s[k].device), s[k], before))
            for s, k in _state_tensors(optimizer, params):
                if (id(s), k) not in seen:
                    s[k].copy_(torch.where(good.to(s[k].device), s[k],
                                           torch.zeros_like(s[k])))
        return loss.detach()

    def validate(self, model, task: Task, max_chunks: Optional[int] = None,
                 epoch: int = 0, eval_batch_size: int = 32) -> Dict:
        """One pass over the task's validation grid (every chunk, or
        ``max_chunks`` of them strided); returns the record's entries."""
        chunks = task.prepare_validation()
        if not chunks:
            return {}
        from ..metrics.auroc import BinnedAUROC
        from ..metrics.streaming import (DetectionErrorRate,
                                         DiarizationErrorRate,
                                         DiarizationPrecision,
                                         DiarizationRecall, FalseAlarmRate,
                                         MissedDetectionRate,
                                         OptimalDiarizationErrorRate,
                                         SpeakerConfusionRate,
                                         unpack_der_components)
        from .evaluate import DEFAULT_THRESHOLDS, make_eval_step, \
            pad_eval_batch

        powerset = getattr(task, "_powerset", None)
        if max_chunks:
            # stride for coverage, then cap
            chunks = chunks[::max(1, len(chunks) // max_chunks)][:max_chunks]
        metrics = {
            "der/val": DiarizationErrorRate(),
            "der/val/false_alarm": FalseAlarmRate(),
            "der/val/missed_detection": MissedDetectionRate(),
            "der/val/confusion": SpeakerConfusionRate(),
            "der/val/precision": DiarizationPrecision(),
            "der/val/recall": DiarizationRecall(),
            "der/val/detection": DetectionErrorRate(),
        }
        optimal = OptimalDiarizationErrorRate()
        auroc = BinnedAUROC()
        eval_step = make_eval_step(model, powerset=powerset)
        with_der = powerset is not None or getattr(task, "val_optimal_der",
                                                   False)
        want_plot = self.log_dir is not None and _power_of_two_or_zero(epoch)
        loss_sum = torch.zeros((), device=self.device)
        state = {"n": 0, "der": False, "auroc": False, "plot": None}

        def flush(batch_X, batch_y):
            if batch_y[0] is None:
                return
            n = len(batch_X)
            X = np.stack(batch_X)
            y = np.stack(batch_y).astype(np.float32)
            if with_der:
                Xp, yp, valid = pad_eval_batch(X, y, eval_batch_size)
                X_dev = to_device(Xp, self.device)
                y_dev = torch.as_tensor(yp).to(self.device)
                hard4, softp, output = eval_step(
                    X_dev, y_dev, torch.as_tensor(valid).to(self.device))
                for m in metrics.values():
                    m.update_from_components(*unpack_der_components(hard4, 1))
                optimal.update_from_components(*unpack_der_components(
                    softp, len(DEFAULT_THRESHOLDS)))
                state["der"] = True
                if want_plot and state["plot"] is None:
                    preds = powerset.to_multilabel(output[:n]) \
                        if powerset is not None else output[:n]
                    state["plot"] = (preds.float().cpu().numpy(), y)
                X_dev, y_dev, output = X_dev[:n], y_dev[:n], output[:n]
            else:
                X_dev = to_device(X, self.device)
                y_dev = torch.as_tensor(y).to(self.device)
                with torch.no_grad():
                    output = model(X_dev)
                preds = output.float().cpu().numpy()
                if preds.ndim == 3:
                    k = min(preds.shape[1], y.shape[1])
                    auroc.update(preds[:, :k], y[:, :k])
                    state["auroc"] = True
                    if state["plot"] is None:
                        state["plot"] = (preds, y)
            with torch.no_grad():
                loss = task.validation_loss(model, output, TrainingBatch(
                    X=X_dev, y=y_dev))
            nonlocal loss_sum
            loss_sum = loss_sum + loss * n
            state["n"] += n

        model.eval()
        try:
            batch_X, batch_y = [], []
            for file, chunk in chunks:
                prepared = task.prepare_chunk(file, chunk,
                                              np.random.default_rng(0))
                if prepared is None:
                    continue
                batch_X.append(prepared["X"])
                batch_y.append(prepared.get("y"))
                if len(batch_X) == eval_batch_size:
                    flush(batch_X, batch_y)
                    batch_X, batch_y = [], []
            if batch_X:
                flush(batch_X, batch_y)
        finally:
            train_mode(model)
        out: Dict = {}
        if state["der"]:
            for name, metric in metrics.items():
                out[name] = metric.compute()
            out["der/val/optimal"] = optimal.compute()
            out["der/val/optimal_threshold"] = optimal.optimal_threshold
        if state["auroc"]:
            out["auroc/val"] = auroc.compute()
        if state["n"]:
            out["loss/val"] = float(loss_sum) / state["n"]
        if want_plot and state["plot"] is not None:
            self._log_validation_figure(
                epoch, *state["plot"],
                warm_up=getattr(task, "warm_up", (0.0, 0.0)),
                duration=task.duration)
        return out

    def _log_validation_figure(self, epoch: int, y_pred: np.ndarray,
                               y: np.ndarray, warm_up=(0.0, 0.0),
                               duration: float = 1.0) -> None:
        """3 x 3 grid of targets over predictions for the first
        validation batch, as ``log_dir/samples_epoch{N}.png``."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        num_frames = y_pred.shape[1]
        warm_up_left = round(warm_up[0] / duration * num_frames)
        warm_up_right = round(warm_up[1] / duration * num_frames)
        num_samples = min(len(y_pred), 9)
        nrows = math.ceil(math.sqrt(num_samples))
        ncols = math.ceil(num_samples / nrows)
        fig, axes = plt.subplots(nrows=2 * nrows, ncols=ncols,
                                 figsize=(8, 5), squeeze=False)
        y = y.astype(np.float32).copy()
        y[y == 0] = np.nan
        if y.ndim == 2:
            y = y[:, :, None]
        y = y * np.arange(y.shape[2])
        for sample_idx in range(num_samples):
            row_idx, col_idx = sample_idx // nrows, sample_idx % ncols
            ax_ref = axes[row_idx * 2 + 0, col_idx]
            ax_ref.plot(y[sample_idx])
            ax_ref.set_xlim(0, y.shape[1])
            ax_ref.set_ylim(-1, y.shape[2])
            ax_ref.get_xaxis().set_visible(False)
            ax_ref.get_yaxis().set_visible(False)
            ax_hyp = axes[row_idx * 2 + 1, col_idx]
            if warm_up_left:
                ax_hyp.axvspan(0, warm_up_left, color="k", alpha=0.5, lw=0)
            if warm_up_right:
                ax_hyp.axvspan(num_frames - warm_up_right, num_frames,
                               color="k", alpha=0.5, lw=0)
            ax_hyp.plot(y_pred[sample_idx])
            ax_hyp.set_ylim(-0.1, 1.1)
            ax_hyp.set_xlim(0, y.shape[1])
            ax_hyp.get_xaxis().set_visible(False)
        plt.tight_layout()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fig.savefig(self.log_dir / f"samples_epoch{epoch}.png", dpi=72)
        plt.close(fig)


def train_mode(model: torch.nn.Module) -> None:
    """``model.train()``, with every BatchNorm kept in eval mode: it
    normalises by its running statistics and leaves them as they are."""
    model.train()
    for module in model.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.eval()


def _power_of_two_or_zero(epoch: int) -> bool:
    """Epochs 0, 1, 2, 4, 8, ... get a figure."""
    return epoch == 0 or (epoch & (epoch - 1)) == 0


def save_checkpoint(model: torch.nn.Module, path: Union[str, Path]) -> Path:
    """``model`` as a reference-layout checkpoint directory that
    ``Model.from_pretrained`` reads."""
    from ..utils.convert import write_reference_checkpoint
    state = model.export_torch_state_dict() \
        if hasattr(model, "export_torch_state_dict") else model.state_dict()
    return write_reference_checkpoint(
        state, type(model).__name__, model.reference_hparams(),
        model.specifications, path)


def _save_atomic(obj: Dict, path: Path) -> None:
    """``torch.save`` through a temporary file and ``os.replace``, so that
    a kill mid-write never leaves a truncated state for ``resume_from``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
