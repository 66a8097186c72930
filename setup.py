from setuptools import find_packages, setup

setup(
    name="pysgmcmc_tpu",
    version="0.1.0",
    description="Stochastic Gradient MCMC framework (JAX/XLA)",
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={"pysgmcmc_tpu": ["native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
)
