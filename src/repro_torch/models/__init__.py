"""Dense transformer model of the port: ``layers``, ``transformer`` (the
layer stack) and ``model`` (the facade)."""
