"""Utilities of the port: structured logging."""
