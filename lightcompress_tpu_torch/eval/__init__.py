from .ppl import DecodePerplexityEval, PerplexityEval, TokenConsistencyEval

__all__ = ["DecodePerplexityEval", "PerplexityEval", "TokenConsistencyEval"]
