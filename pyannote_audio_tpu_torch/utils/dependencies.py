"""Checkpoint dependency and version gating.

Counterpart of pyannote_audio_tpu/utils/dependencies.py: warn (or, with
``strict``, raise) when a checkpoint was produced with library versions
other than the running environment's. ``installed_version`` answers for
this package from its ``__version__``.
"""

from __future__ import annotations

import warnings
from importlib.metadata import PackageNotFoundError, version
from typing import Dict, Optional


class DependencyError(Exception):
    pass


class MissingDependency(DependencyError):
    """A recorded dependency is not installed at all."""


class WrongDependencyVersion(DependencyError):
    """A recorded dependency is installed at an incompatible version."""


def installed_version(package: str) -> Optional[str]:
    if package == "pyannote_audio_tpu_torch":
        from .. import __version__
        return __version__
    try:
        return version(package)
    except PackageNotFoundError:
        return None


def check_dependencies(dependencies: Dict[str, str],
                       what: str = "checkpoint",
                       strict: bool = False) -> None:
    """Compare recorded versions against the running environment: a
    missing package or another version warns; with ``strict`` a missing
    package raises, and so does another major version."""
    for package, expected in (dependencies or {}).items():
        current = installed_version(package)
        if current is None:
            msg = (f"{what} was created with {package}=={expected} which "
                   f"is not installed.")
            if strict:
                raise MissingDependency(msg)
            warnings.warn(msg)
        elif current != expected:
            msg = (f"{what} was created with {package}=={expected}; "
                   f"found {current}. Results may differ.")
            if strict and current.split(".")[0] != expected.split(".")[0]:
                raise WrongDependencyVersion(msg)
            warnings.warn(msg)
