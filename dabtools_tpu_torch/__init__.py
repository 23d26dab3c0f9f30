"""dabtools_tpu_torch: the dab2eti decode path in PyTorch, with the Viterbi
as hand-written CUDA kernels for Hopper (sm_90a).

A port of :mod:`dabtools_tpu` (the JAX reference, which stays in the
repository and against which every module here is tested).  The module
layout mirrors the JAX package, so ``dabtools_tpu/ops/sync.py`` has its
counterpart in ``dabtools_tpu_torch/ops/sync.py`` and so on.

Rules of the package:

* It imports ``torch`` and never ``jax``, and nothing of ``dabtools_tpu``.
  The host-only NumPy modules it needs (``constants``, ``tables``,
  ``fic``, ``eti``, ``utils``, ``mod`` and ``native/dabhost.cc``) are
  copies of the JAX package's, identical but for their import lines.
* Every device function takes tensors on one explicit device.  A CUDA
  tensor reaches the hand-written kernels (``ops/cudalib.py``) or the
  call raises; a CPU tensor takes the plain PyTorch version of each kernel.
  Nothing moves work to the CPU on its own.

Quick start::

    from dabtools_tpu_torch.models.receiver import DabReceiver
    rx = DabReceiver(n_frames=16, device="cuda")
    eti_frames = rx.feed(iq_samples)   # complex64 or u8 IQ @ 2.048 Msps
"""

__version__ = "0.1.0"
