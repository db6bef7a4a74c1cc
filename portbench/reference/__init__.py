"""Plain PyTorch references of the cells' models and their judges; none
imports the program."""
