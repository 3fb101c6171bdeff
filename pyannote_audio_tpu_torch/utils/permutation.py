"""The reference's ``utils/permutation`` names, from ``ops.permutation``."""

from ..ops.permutation import (mae_cost_func, mse_cost_func, pairwise_cost,
                               permutate, permutation_table)

__all__ = ["permutate", "mse_cost_func", "mae_cost_func", "pairwise_cost",
           "permutation_table"]
