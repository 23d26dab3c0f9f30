"""CLI entry points of the PyTorch port: ``python -m
dabtools_tpu_torch.cli.dab2eti`` (IQ file or stdin -> ETI(NI))."""
