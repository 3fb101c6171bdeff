"""Tunable hyperparameter declarations for pipelines.

Counterpart of pyannote_audio_tpu/core/parameter.py (the reference's
``pyannote.pipeline.parameter``): ``Uniform``, ``LogUniform``,
``Integer``, ``Categorical``, ``Frozen`` and ``ParamDict``, which a
pipeline assigns as attributes to declare its tunable knobs. Plain Python.
"""

from __future__ import annotations

import random
from typing import Any, Iterable, Optional


class Parameter:
    """Base class: a declared-but-not-yet-instantiated hyperparameter."""

    def sample(self, rng: Optional[random.Random] = None) -> Any:
        raise NotImplementedError

    def __contains__(self, value: Any) -> bool:
        raise NotImplementedError


class Uniform(Parameter):
    def __init__(self, low: float, high: float):
        self.low = float(low)
        self.high = float(high)

    def sample(self, rng=None):
        rng = rng or random
        return rng.uniform(self.low, self.high)

    def __contains__(self, value):
        return self.low <= value <= self.high

    def __repr__(self):
        return f"Uniform({self.low}, {self.high})"


class LogUniform(Parameter):
    def __init__(self, low: float, high: float):
        import math
        self.low = float(low)
        self.high = float(high)
        self._log = (math.log(low), math.log(high))

    def sample(self, rng=None):
        import math
        rng = rng or random
        return math.exp(rng.uniform(*self._log))

    def __contains__(self, value):
        return self.low <= value <= self.high

    def __repr__(self):
        return f"LogUniform({self.low}, {self.high})"


class Integer(Parameter):
    def __init__(self, low: int, high: int):
        self.low = int(low)
        self.high = int(high)

    def sample(self, rng=None):
        rng = rng or random
        return rng.randint(self.low, self.high)

    def __contains__(self, value):
        return self.low <= value <= self.high and int(value) == value

    def __repr__(self):
        return f"Integer({self.low}, {self.high})"


class Categorical(Parameter):
    def __init__(self, choices: Iterable[Any]):
        self.choices = list(choices)

    def sample(self, rng=None):
        rng = rng or random
        return rng.choice(self.choices)

    def __contains__(self, value):
        return value in self.choices

    def __repr__(self):
        return f"Categorical({self.choices})"


class Frozen(Parameter):
    """A parameter pinned to a fixed value (excluded from optimization)."""

    def __init__(self, value: Any):
        self.value = value

    def sample(self, rng=None):
        return self.value

    def __contains__(self, value):
        return value == self.value

    def __repr__(self):
        return f"Frozen({self.value!r})"


class ParamDict(dict, Parameter):
    """A named collection of sub-parameters."""

    def __init__(self, **params):
        super().__init__(**params)

    def sample(self, rng=None):
        return {k: v.sample(rng) if isinstance(v, Parameter) else v
                for k, v in self.items()}

    def __contains__(self, value):
        # Parameter contract: validity of a candidate VALUE — a mapping
        # must assign every sub-parameter a valid value. Non-mapping
        # arguments keep plain dict key-containment semantics.
        from collections.abc import Mapping
        if isinstance(value, Mapping):
            return all(
                k in value and (value[k] in v if isinstance(v, Parameter)
                                else True)
                for k, v in self.items())
        return dict.__contains__(self, value)
