"""Command-line launchers of the port (``python -m repro_torch.launch.serve``)
and the device mesh (:mod:`.mesh`)."""
