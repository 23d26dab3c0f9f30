"""Test-signal modulator, convolutional code and impairments (NumPy)."""
