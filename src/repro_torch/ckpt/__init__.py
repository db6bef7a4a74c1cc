"""Checkpoints (counterpart of ``repro.ckpt``)."""
