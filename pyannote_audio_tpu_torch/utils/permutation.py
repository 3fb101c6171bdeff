"""The reference's ``utils/permutation`` names, from ``ops.permutation``."""

from ..ops.permutation import (build_permutation_graph, mae_cost_func,
                               mse_cost_func, pairwise_cost, permutate,
                               permutate_numpy, permutate_torch,
                               permutation_table)

__all__ = ["permutate", "permutate_numpy", "permutate_torch",
           "mse_cost_func", "mae_cost_func", "pairwise_cost",
           "permutation_table", "build_permutation_graph"]
