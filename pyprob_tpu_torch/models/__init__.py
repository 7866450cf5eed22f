from .models import (
    BayesianLinearRegression,
    BayesianLogisticRegression,
    Branching,
    BranchingCompiled,
    EightSchools,
    GaussianMixture,
    GaussianProcessRegression,
    GaussianUnknownMean,
    GaussianUnknownMeanMarsaglia,
    GaussianUnknownMeanMarsagliaRejection,
    HiddenMarkovModel,
    LinearGaussianStateSpace,
)

__all__ = [
    "BayesianLinearRegression",
    "BayesianLogisticRegression",
    "Branching",
    "BranchingCompiled",
    "EightSchools",
    "GaussianMixture",
    "GaussianProcessRegression",
    "GaussianUnknownMean",
    "GaussianUnknownMeanMarsaglia",
    "GaussianUnknownMeanMarsagliaRejection",
    "HiddenMarkovModel",
    "LinearGaussianStateSpace",
]
