"""Ownership markers of the port's serving engine."""
