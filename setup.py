"""Packaging for gym_fishing_tpu (pure-Python + Pallas kernels; reference
parity: gym_fishing's setup.py, reconstructed — SURVEY.md §2.1) and its
PyTorch/CUDA port gym_fishing_tpu_torch (install with the `torch` extra; its
CUDA sources ship as package data and are built with nvcc on first use)."""

from setuptools import find_packages, setup

setup(
    name="gym_fishing_tpu",
    version="0.1.0",
    description=(
        "TPU-native vectorized fisheries-management RL environments "
        "(gym_fishing rebuilt on JAX/XLA/Pallas)"
    ),
    author="gym_fishing_tpu developers",
    license="MIT",
    packages=find_packages(exclude=("tests",)),
    package_data={"gym_fishing_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "validation/*.json"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pandas",
        "matplotlib",
    ],
    extras_require={
        "learn": ["flax", "optax"],
        "gym": ["gymnasium"],
        "ckpt": ["orbax-checkpoint"],   # optional backend; npz is built in
        "test": ["pytest"],
        "torch": ["torch"],  # gym_fishing_tpu_torch; its kernels also need nvcc
    },
)
