from .models import (
    GaussianProcessRegression,
    GaussianUnknownMean,
    GaussianUnknownMeanMarsagliaRejection,
)

__all__ = [
    "GaussianProcessRegression",
    "GaussianUnknownMean",
    "GaussianUnknownMeanMarsagliaRejection",
]
