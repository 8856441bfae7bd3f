"""Launchers of the port: ``python -m repro_torch.launch.serve``.  The
reference's ``dryrun`` and ``inputs`` lower and read compiled XLA and have
no counterpart here; ``train`` comes with the training slice."""
