"""Spectral and layout primitives, and the x-update solve kernel."""
