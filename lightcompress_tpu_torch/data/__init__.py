from .dataset import CalibDataset, batch_samples, synthetic_random

__all__ = ["CalibDataset", "batch_samples", "synthetic_random"]
