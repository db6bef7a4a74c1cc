"""The port's models: ``layers`` (attention, MLP, norms), ``ssm`` (the
mamba2 block), ``rglru`` (the RG-LRU block), ``transformer`` (the layer
stack) and ``model`` (the facade)."""
