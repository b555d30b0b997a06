"""Data helpers of the port (a port-local vocabulary)."""
