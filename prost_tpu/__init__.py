"""prost_tpu — a JAX framework for large-scale convex-concave
saddle-point problems with proximal structure:

    min_x max_y  g(x) + <Kx, y> - f*(y)

Re-designed from scratch for JAX/XLA with the capabilities of the
reference CUDA/MATLAB implementation (tum-vision/prost, mounted at
/root/reference): block-structured linear operators, a zoo of proximal
operators, PDHG and graph-projection ADMM backends with diagonal
(Pock-Chambolle) preconditioning and adaptive step sizes, and a Python
modeling layer replacing the MATLAB one.
"""

from .config import ProstError, dtype, list_devices, set_device, set_dtype
from .problem import Problem, SCALING_ALPHA, SCALING_CUSTOM, SCALING_IDENTITY
from .solver import ConvergenceResult, Solver, SolverOptions, SolverResult
from .modeling import (
    MinMaxProblem,
    MinProblem,
    SubVariable,
    Variable,
    backend_admm,
    backend_pdhg,
    eval_linop,
    eval_prox,
    get_all_variables,
    options,
    solve,
)
from .modeling import block, function

__version__ = "0.1.0"

__all__ = [
    "ProstError",
    "dtype",
    "set_dtype",
    "list_devices",
    "set_device",
    "Problem",
    "SCALING_ALPHA",
    "SCALING_CUSTOM",
    "SCALING_IDENTITY",
    "ConvergenceResult",
    "Solver",
    "SolverOptions",
    "SolverResult",
    "Variable",
    "SubVariable",
    "MinMaxProblem",
    "MinProblem",
    "solve",
    "options",
    "backend_pdhg",
    "backend_admm",
    "eval_prox",
    "eval_linop",
    "get_all_variables",
    "function",
    "block",
    "__version__",
]
