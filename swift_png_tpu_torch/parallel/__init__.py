"""Batched decode entry points of the port."""
