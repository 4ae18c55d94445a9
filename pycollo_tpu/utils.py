"""Small shared utilities: options registries, formatting helpers and the
location of JAX's persistent compilation cache.

``Options`` reproduces the capability of the reference's
options-registry-with-unsupported-markers pattern (pyproprop ``Options`` used
at ``pycollo/backend.py:1925``, ``pycollo/quadrature.py:34`` etc.) without the
pyproprop dependency: a tuple of valid keyword options, a default, and a set
of enumerated-but-unsupported options that raise on use.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Optional

#: Default persistent compilation cache: one fixed directory inside the
#: checkout (listed in ``.gitignore``).  The directory is part of the
#: cache key, so a cache that moves between runs never hits.
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed.  Otherwise the cache goes to
    :data:`DEFAULT_COMPILE_CACHE`.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = str(DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class Options:
    """Registry of keyword options with a default and unsupported markers."""

    def __init__(self, options: Iterable[str], default: Optional[str] = None,
                 unsupported: Iterable[str] = ()):
        self.options = tuple(options)
        if isinstance(unsupported, str):
            unsupported = (unsupported,)
        self.unsupported = tuple(unsupported)
        for unsup in self.unsupported:
            if unsup not in self.options:
                raise ValueError(f"Unsupported option {unsup!r} is not one of "
                                 f"the enumerated options {self.options}.")
        if default is None:
            default = self.options[0]
        if default not in self.options:
            raise ValueError(f"Default {default!r} not in {self.options}.")
        if default in self.unsupported:
            raise ValueError(f"Default {default!r} is marked unsupported.")
        self.default = default

    def validate(self, value: str) -> str:
        if isinstance(value, str):
            value = value.casefold().strip()
        if value not in self.options:
            raise ValueError(f"{value!r} is not a valid option. Choose one of "
                             f"{self.options}.")
        if value in self.unsupported:
            supported = tuple(o for o in self.options
                              if o not in self.unsupported)
            raise ValueError(f"{value!r} is not currently supported. "
                             f"Choose one of {supported}.")
        return value


def format_case(item: str, case: str = "title") -> str:
    """Format an identifier-ish string for display."""
    words = str(item).replace("_", " ").split()
    if case == "title":
        return " ".join(w.capitalize() for w in words)
    return " ".join(words)


def format_time(seconds: float) -> str:
    """Human-readable duration (capability of ``pycollo/utils.py:format_time``)."""
    if seconds < 1e-3:
        return f"{seconds * 1e6:.2f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    if seconds < 60.0:
        return f"{seconds:.2f} s"
    minutes, rem = divmod(seconds, 60.0)
    return f"{int(minutes)} min {rem:.1f} s"


def console_out(message: str, heading: bool = False) -> None:
    """Print a progress message, optionally underlined as a heading."""
    if heading:
        bar = "=" * len(message)
        print(f"\n{message}\n{bar}\n")
    else:
        print(message)
