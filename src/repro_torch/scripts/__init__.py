"""The port's scripts, each the counterpart of a file of the repo's
``scripts/`` under the same name, run as ``python -m
repro_torch.scripts.<name>``: the offline report readers
(``power_report``, ``trace_report``) and the dry-run sweeps
(``optimize_all``, ``hillclimb``).  None of them does device work."""
