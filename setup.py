"""Packaging (ament-free counterpart of the reference `setup.py`)."""

from setuptools import find_packages, setup

setup(
    name="boundplanner_tpu",
    version="0.1.0",
    description=(
        "Batched convex-set path planning + error-bounded MPC engine "
        "(JAX/XLA/Pallas) for 7-DoF arms"
    ),
    packages=find_packages(include=["boundplanner_tpu", "boundplanner_tpu.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "test": ["pytest", "chex"],
    },
    include_package_data=True,
)
