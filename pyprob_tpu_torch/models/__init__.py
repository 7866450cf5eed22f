from .models import GaussianUnknownMean

__all__ = ["GaussianUnknownMean"]
