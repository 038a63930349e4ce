from . import limbmath

__all__ = ["limbmath"]
