from .models import GaussianUnknownMean, GaussianUnknownMeanMarsagliaRejection

__all__ = ["GaussianUnknownMean", "GaussianUnknownMeanMarsagliaRejection"]
