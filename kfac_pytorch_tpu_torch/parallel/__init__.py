"""Eigen refresh placement (single device in this port so far)."""
