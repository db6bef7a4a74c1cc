"""Core of the port: hardware and node power points (``power``)."""
