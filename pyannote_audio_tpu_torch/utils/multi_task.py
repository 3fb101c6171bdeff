"""Apply a function per Specifications (single- or multi-task models).

Counterpart of pyannote_audio_tpu/utils/multi_task.py.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

from ..core.model import Specifications


def map_with_specifications(
    specifications: Union[Specifications, Tuple[Specifications, ...]],
    func: Callable,
    *iterables,
) -> Union[Any, Tuple[Any, ...]]:
    """Call ``func(spec, *items)`` once per specification: with one
    ``Specifications``, on the iterables themselves; with a tuple of
    them, on the i-th item of each iterable, returning a tuple."""
    if isinstance(specifications, Specifications):
        return func(specifications, *iterables)
    return tuple(func(spec, *(it[i] for it in iterables))
                 for i, spec in enumerate(specifications))
