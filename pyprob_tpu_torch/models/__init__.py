from .models import (
    GaussianProcessRegression,
    GaussianUnknownMean,
    GaussianUnknownMeanMarsaglia,
    GaussianUnknownMeanMarsagliaRejection,
)

__all__ = [
    "GaussianProcessRegression",
    "GaussianUnknownMean",
    "GaussianUnknownMeanMarsaglia",
    "GaussianUnknownMeanMarsagliaRejection",
]
