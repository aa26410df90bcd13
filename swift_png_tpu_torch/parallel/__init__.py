"""Batched decode and encode entry points of the port."""
