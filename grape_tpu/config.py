"""Global numeric configuration for grape_tpu.

The reference implementation (GRAPE.jl) runs everything in Float64/ComplexF64 on
CPU.  On an accelerator the fast arithmetic is float32/complex64; float64
(``jax.config.update("jax_enable_x64", True)``) runs at a fraction of that
rate.  We therefore make the working precision explicit and configurable:

- tests run on CPU with x64 enabled (complex128) to reproduce the reference's
  1e-10..1e-14 tolerance anchors,
- accelerator runs default to complex64 unless the caller asks for x64.
"""

import jax
import jax.numpy as jnp

__all__ = ["real_dtype", "complex_dtype", "default_float", "default_complex"]


def default_float():
    """The widest available real dtype (float64 iff x64 is enabled)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_complex():
    """The widest available complex dtype (complex128 iff x64 is enabled)."""
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


def real_dtype(dtype):
    """The real dtype matching a given (possibly complex) dtype."""
    return jnp.finfo(dtype).dtype if not jnp.issubdtype(dtype, jnp.complexfloating) \
        else (jnp.float64 if dtype == jnp.complex128 else jnp.float32)


def complex_dtype(dtype):
    """The complex dtype matching a given (possibly real) dtype."""
    if jnp.issubdtype(dtype, jnp.complexfloating):
        return dtype
    return jnp.complex128 if dtype == jnp.float64 else jnp.complex64
