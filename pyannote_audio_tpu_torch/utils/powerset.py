"""The reference's ``utils/powerset`` names, from ``ops.powerset``."""

from ..ops.powerset import Powerset, build_powerset_mapping

__all__ = ["Powerset", "build_powerset_mapping"]
