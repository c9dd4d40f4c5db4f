"""Drivers of the port (entry points run with ``python -m``)."""
