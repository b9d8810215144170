"""Drivers: one module for each kind of job a cell runs, named by the cell\x27s ``driver`` key."""
