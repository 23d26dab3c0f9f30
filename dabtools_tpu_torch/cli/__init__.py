"""CLI entry points of the PyTorch port: ``python -m
dabtools_tpu_torch.cli.dab2eti`` (IQ file, stdin or RTL-SDR -> ETI(NI))
and ``python -m dabtools_tpu_torch.cli.dabscan`` (wideband capture ->
the ensembles in it)."""
