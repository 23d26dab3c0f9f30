"""Receiver models of the PyTorch port.

``models.receiver.DabReceiver`` is the flagship: IQ samples in, ETI(NI)
bytes out, the ``dab2eti`` decode path.
"""
