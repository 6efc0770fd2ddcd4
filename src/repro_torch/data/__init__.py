from .pipeline import Batch, PrefetchIterator, SyntheticLMData

__all__ = ["Batch", "PrefetchIterator", "SyntheticLMData"]
