"""Ensembles: the members of a model advanced together, on one device or
split over the ranks of a dp mesh (mesh.py)."""
from .ensemble import Ensemble

__all__ = ["Ensemble"]
