"""Training callbacks: gradual unfreezing.

Counterpart of pyannote_audio_tpu/core/callback.py: at the start of each
epoch the callback sets ``trainer.frozen_prefixes``, the parameter-name
prefixes whose updates ``Trainer.fit`` zeroes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

Schedule = Union[List[Union[str, List[str]]], Dict[str, int]]


class GraduallyUnfreeze:
    """Unfreeze parameter groups on an epoch schedule.

    schedule: a list (one group unfrozen every ``epochs_per_stage``
    epochs), e.g. ``["linear", "lstm", "sincnet"]``, or a dict {prefix:
    epoch at which it unfreezes}. By default every top-level module but
    the classifier starts frozen, and they unfreeze from the last to the
    first.
    """

    def __init__(self, schedule: Optional[Schedule] = None,
                 epochs_per_stage: int = 1):
        self.schedule = schedule
        self.epochs_per_stage = epochs_per_stage
        self._plan: Dict[str, int] = {}

    def _resolve(self, model) -> Dict[str, int]:
        schedule = self.schedule
        if schedule is None:
            top_level = [name for name, _ in model.named_children()
                         if name != "classifier"]
            schedule = list(reversed(top_level))
        if isinstance(schedule, dict):
            return dict(schedule)
        plan: Dict[str, int] = {}
        for stage, group in enumerate(schedule):
            prefixes = [group] if isinstance(group, str) else list(group)
            for prefix in prefixes:
                plan[prefix] = (stage + 1) * self.epochs_per_stage
        return plan

    def on_fit_start(self, trainer, model):
        self._plan = self._resolve(model)
        self._apply(trainer, model, epoch=0)

    def on_train_epoch_start(self, trainer, model, epoch: int):
        self._apply(trainer, model, epoch)

    def frozen_prefixes(self, epoch: int) -> List[str]:
        return [prefix for prefix, at in self._plan.items() if epoch < at]

    def _apply(self, trainer, model, epoch: int):
        trainer.frozen_prefixes = self.frozen_prefixes(epoch)
