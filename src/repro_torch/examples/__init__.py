"""The port's examples, each the counterpart of a file of the repo's
``examples/`` under the same name, run as ``python -m
repro_torch.examples.<name>``: the paper's MRI-Q pattern search measured
on the card (``mriq_offload``), the analytic GA (``quickstart``), the
destination ladder (``mixed_destination``), Steps 1-7 (``adapt_flow``) and
training (``train_lm``)."""
