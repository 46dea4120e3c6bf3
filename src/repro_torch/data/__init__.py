from .pipeline import SyntheticTokens, make_batches

__all__ = ["SyntheticTokens", "make_batches"]
