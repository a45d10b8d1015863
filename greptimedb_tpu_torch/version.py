"""The package version (the JAX package's version.py)."""

__version__ = "0.1.0"
