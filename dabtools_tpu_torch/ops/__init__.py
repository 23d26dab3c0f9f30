"""Device-side signal ops in PyTorch: the receiver compute path.

Plain functions on tensors.  Tables are built from the port's NumPy
``tables`` and cached per ``(key, device)``; a vmap of the JAX package is an
explicit leading batch axis here.  The Viterbi ACS and traceback run as
hand-written CUDA kernels on a CUDA tensor (``viterbi_cuda``) and as their
plain PyTorch versions (``viterbi``) on a CPU tensor.  ``cudalib`` builds,
loads and launches the library of every hand-written kernel.  ``rs`` decodes
batches of shortened Reed-Solomon codewords (DAB+ RS(120,110), packet FEC
RS(204,188)) as torch ops on the device of the tensor it is given.
"""
