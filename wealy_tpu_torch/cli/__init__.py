"""Command-line entry points of the port (model loading for now)."""
