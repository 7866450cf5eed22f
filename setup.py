from setuptools import setup, find_packages

with open("README.md") as f:
    long_description = f.read()

setup(
    name="pyprob_tpu",
    version="0.1.0",
    description=(
        "TPU-native trace-based universal probabilistic programming: "
        "importance sampling, inference compilation, single-site MCMC, "
        "SMC, HMC/NUTS, VI, parallel tempering, tempered SMC and SVGD "
        "compiled under jax.vmap/jit, with the PPX cross-language protocol "
        "and a posterior serving layer."
    ),
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(
        include=["pyprob_tpu", "pyprob_tpu.*", "pyprob_tpu_torch", "pyprob_tpu_torch.*"]
    ),
    package_data={
        "pyprob_tpu.ppx": ["ppx.fbs"],
        "pyprob_tpu_torch.ops": ["csrc/*.cu"],
        "pyprob_tpu_torch.models": ["glyphs_dejavusans_bold_18.bin"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "flatbuffers",
        "pyzmq",
        "scipy",
        "pyyaml",
    ],
    extras_require={
        "full": ["matplotlib", "scikit-learn"],
        "test": ["pytest"],
    },
    license="BSD-2-Clause",
)
