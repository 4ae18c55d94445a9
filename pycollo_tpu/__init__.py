"""pycollo_tpu: an on-device multiphase optimal control framework.

A from-scratch reimplementation of the capabilities of pycollo (direct
orthogonal collocation for multiphase optimal control) built on
JAX/XLA/Pallas: user dynamics are JAX-traced (or sympy expressions traced
through the symbolic frontend), the transcribed NLP is evaluated for all
mesh nodes of all phases in batched passes, and the NLP is solved by an
on-device condensed-space primal-dual interior-point method.  Thousands of
perturbed problem instances solve simultaneously via ``vmap`` and device
meshes (``pycollo_tpu.parallel``).

Public API parity with ``pycollo/__init__.py:1-16``.
"""

import jax as _jax

# The collocation/IPM numerics require double precision.
_jax.config.update("jax_enable_x64", True)

from .bounds import EndpointBounds, PhaseBounds          # noqa: E402,F401
from .guess import EndpointGuess, PhaseGuess             # noqa: E402,F401
from .mesh import PhaseMesh                              # noqa: E402,F401
from .ocp import OptimalControlProblem                   # noqa: E402,F401
from .phase import Phase                                 # noqa: E402,F401
from .settings import Settings                           # noqa: E402,F401
from .structures import Endpoints, PhaseEndpoints        # noqa: E402,F401
from .user_scaling import EndpointScaling, PhaseScaling  # noqa: E402,F401

__all__ = [
    "OptimalControlProblem",
    "Phase",
    "EndpointBounds",
    "PhaseBounds",
    "EndpointGuess",
    "PhaseGuess",
    "PhaseMesh",
    "Settings",
    "Endpoints",
    "PhaseEndpoints",
]

__version__ = "0.1.0"
