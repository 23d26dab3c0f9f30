"""The signal generator: a frozen copy of the port's NumPy transmitter
chain (``mod/``, ``fic/``, the tables, ``utils/{prbs,crc}.py`` and
``testsignal.py``'s builders) that imports nothing of the program, and
``pool.py``, the looped pool a run streams."""
