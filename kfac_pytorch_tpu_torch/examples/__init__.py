"""Trainers of the port (run with ``python -m``)."""
