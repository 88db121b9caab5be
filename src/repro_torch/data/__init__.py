"""Data pipeline substrate."""

from .pipeline import DataConfig, TokenStream, make_batch_specs

__all__ = ["DataConfig", "TokenStream", "make_batch_specs"]
