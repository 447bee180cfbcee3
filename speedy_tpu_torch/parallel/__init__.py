"""Ensembles: the members of a model advanced together, on one device or
split over the ranks of a dp x sp mesh (mesh.py): members over 'dp',
latitude bands over 'sp'."""
from .ensemble import Ensemble

__all__ = ["Ensemble"]
