"""isplib_tpu package build (analog of /root/reference/setup.py, minus the
torch CppExtension machinery — the native lib builds via
`python -m isplib_tpu.native.build`)."""

from setuptools import find_packages, setup

setup(
    name="isplib_tpu",
    version="0.1.0",
    description=("TPU-native sparse GNN message-passing framework "
                 "(JAX/XLA/Pallas) with the capabilities of iSpLib"),
    packages=find_packages(include=["isplib_tpu", "isplib_tpu.*",
                                    "isplib_tpu_torch",
                                    "isplib_tpu_torch.*"]),
    # the PyTorch/CUDA port builds these at first use: the kernels with
    # nvcc, its graph builder with g++
    package_data={"isplib_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"],
                  "isplib_tpu_torch.native": ["csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "ckpt": ["orbax-checkpoint"],
        "data": ["scipy"],
        "torch": ["torch"],
    },
)
