"""grape_tpu — a JAX GRAPE quantum-optimal-control framework.

A JAX/XLA implementation with the capabilities of GRAPE.jl
(JuliaQuantumControl; reference at /root/reference, structural analysis in
SURVEY.md): piecewise-constant pulse optimization over Schrödinger/Liouville
dynamics for arbitrary final-time functionals plus pulse- and state-dependent
running costs, exact per-time-step gradients (augmented-matrix Fréchet or
Taylor recursion), semi-automatic differentiation of functionals via
``jax.grad``, and a host-side L-BFGS-B optimizer with box constraints.

Public API (reference ``src/GRAPE.jl:13-17`` / ``docs/src/api.md``):
``optimize``, ``GrapeResult``, ``Trajectory``, plus the problem/model builders
and functionals library.
"""

from .amplitudes import (
    ComplexAmplitude, CustomAmplitude, LockedAmplitude, ShapedAmplitude,
)
from .controls import discretize, discretize_on_midpoints, get_controls
from .generators import Generator, align_generators, hamiltonian, liouvillian
from .info_table import make_grape_print_iters
from .interfaces import check_generator, check_problem, check_state
from .io import load_optimization, load_result, optimize_or_load, save_result
from .krotov import KrotovResult, optimize_krotov
from .optimize import optimize, optimize_problem
from .propagate import propagate, substitute
from .result import GrapeResult
from .trajectory import ControlProblem, Trajectory
from .workspace import (
    GrapeWrk, gradient, norm_search, pulse_update, search_direction,
    step_width, vec_angle,
)
from .functionals import set_default_ad_framework
from . import functionals, shapes

__version__ = "0.1.0"

__all__ = [
    "optimize", "optimize_problem", "optimize_krotov", "KrotovResult",
    "GrapeResult", "Trajectory",
    "ControlProblem", "hamiltonian", "liouvillian", "Generator",
    "align_generators", "ShapedAmplitude", "LockedAmplitude",
    "ComplexAmplitude", "CustomAmplitude",
    "discretize", "discretize_on_midpoints",
    "get_controls", "functionals", "shapes", "propagate", "substitute",
    "save_result", "load_result", "optimize_or_load", "load_optimization",
    "check_state", "check_generator", "check_problem",
    "make_grape_print_iters", "set_default_ad_framework",
    "GrapeWrk", "step_width", "search_direction", "norm_search", "gradient",
    "pulse_update", "vec_angle",
]
