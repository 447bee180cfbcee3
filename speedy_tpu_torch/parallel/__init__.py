"""Ensembles: the members of a model advanced together on one device."""
from .ensemble import Ensemble

__all__ = ["Ensemble"]
