from .raw import standardize

__all__ = ["standardize"]
