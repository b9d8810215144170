"""Configuration of the port (``config.py``); training comes with a later
slice."""
