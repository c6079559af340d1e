"""paddle.tensor random functions (dual-mode; counterpart of
paddle_tpu/tensor/random.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

from ..core.dtype import convert_dtype
from ._dispatch import dispatch

__all__ = ["rand", "randn", "randint", "randperm", "uniform", "normal",
           "bernoulli", "multinomial", "standard_normal"]


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    return dispatch("uniform_random", {},
                    {"shape": list(shape), "dtype": convert_dtype(dtype),
                     "min": float(min), "max": float(max), "seed": seed},
                    name=name)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype or "float32", 0.0, 1.0, name=name)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    # tensor mean/std: broadcast sample over their shape
    if hasattr(mean, "shape") or hasattr(std, "shape"):
        from . import math as M
        base = mean if hasattr(mean, "shape") else std
        eps = dispatch("gaussian_random", {},
                       {"shape": list(base.shape), "dtype": "float32",
                        "mean": 0.0, "std": 1.0}, name=name)
        return M.add(M.multiply(eps, std) if hasattr(std, "shape")
                     else M.scale(eps, float(std)), mean)
    if shape is None:
        raise ValueError("normal(): `shape` is required when mean and std "
                         "are scalars")
    return dispatch("gaussian_random", {},
                    {"shape": list(shape), "dtype": "float32",
                     "mean": float(mean), "std": float(std)}, name=name)


def randn(shape, dtype=None, name=None):
    return dispatch("gaussian_random", {},
                    {"shape": list(shape),
                     "dtype": convert_dtype(dtype or "float32"),
                     "mean": 0.0, "std": 1.0}, name=name)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return dispatch("randint", {},
                    {"low": int(low), "high": int(high),
                     "shape": list(shape), "dtype": convert_dtype(dtype)},
                    name=name)


def randperm(n, dtype="int64", name=None):
    return dispatch("randperm", {},
                    {"n": int(n), "dtype": convert_dtype(dtype)}, name=name)


def bernoulli(x, name=None):
    return dispatch("bernoulli", {"X": x}, name=name)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return dispatch("multinomial", {"X": x},
                    {"num_samples": int(num_samples),
                     "replacement": bool(replacement)}, name=name)
