from setuptools import find_packages, setup

setup(
    name="hypervla_tpu",
    version="0.1.0",
    description=(
        "TPU-native hypernetwork vision-language-action framework "
        "(JAX/XLA/GSPMD/Pallas)"
    ),
    packages=find_packages(include=["hypervla_tpu*", "hypervla_tpu_torch*"]),
    package_data={"hypervla_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pillow",
        "ml_collections",
        "absl-py",
    ],
    extras_require={
        "eval": ["gym"],
        "test": ["pytest"],
    },
)
