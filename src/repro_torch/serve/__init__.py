"""Serving of the port: ``engine`` (steps + the continuous-batching loop)."""
