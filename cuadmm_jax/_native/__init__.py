"""Native (C++) accelerators with graceful fallback.

Build with ``python -m cuadmm_jax.build_native``; importers fall back to
NumPy parsing when the extension is absent.
"""

try:
    from cuadmm_jax._native import txtio  # noqa: F401

    HAVE_NATIVE = True
except ImportError:
    txtio = None
    HAVE_NATIVE = False
