"""Integrators, boundaries and simulation drivers."""
