from .models import (
    Branching,
    BranchingCompiled,
    GaussianProcessRegression,
    GaussianUnknownMean,
    GaussianUnknownMeanMarsaglia,
    GaussianUnknownMeanMarsagliaRejection,
    HiddenMarkovModel,
)

__all__ = [
    "Branching",
    "BranchingCompiled",
    "GaussianProcessRegression",
    "GaussianUnknownMean",
    "GaussianUnknownMeanMarsaglia",
    "GaussianUnknownMeanMarsagliaRejection",
    "HiddenMarkovModel",
]
