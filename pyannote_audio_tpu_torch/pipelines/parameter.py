"""Re-export of the hyperparameter declarations (``core/parameter.py``),
at the path where the JAX package's pipelines import them."""

from ..core.parameter import (Categorical, Frozen, Integer, LogUniform,
                              ParamDict, Parameter, Uniform)

__all__ = ["Categorical", "Frozen", "Integer", "LogUniform", "ParamDict",
           "Parameter", "Uniform"]
