"""The reference's ``utils/loss`` names, from ``ops.losses``."""

from ..ops.losses import (binary_cross_entropy, interpolate,
                          interpolate_weight, mse_loss, nll_loss,
                          powerset_pit_loss)

__all__ = ["binary_cross_entropy", "mse_loss", "nll_loss",
           "interpolate", "interpolate_weight", "powerset_pit_loss"]
