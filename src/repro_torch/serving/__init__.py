"""Serving layer of the port: the paged engine and its scheduler."""
