"""Training: optimizers, gradient compression and the train step
(counterpart of ``repro.train``)."""
