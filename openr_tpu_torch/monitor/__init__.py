"""Observability of the port: named spans of the solver's phases."""
