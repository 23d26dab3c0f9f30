"""CLI entry points of the PyTorch port, ``python -m
dabtools_tpu_torch.cli.<command>``:

  ``dab2eti``   IQ file, stdin or RTL-SDR -> ETI(NI); decodes on
                ``--torch-device`` (``cuda`` by default, the only command
                that touches the card)
  ``dabscan``   wideband capture -> the ensembles in it (same device flag)
  ``dabmux``    JSON mux configuration -> ETI(NI)
  ``etiinfo``   ETI(NI) -> its ensemble, services and metadata
  ``etiremux``  ETI(NI) -> ETI(NI) with sub-channels kept or dropped
  ``eti2edi``   ETI(NI) -> EDI (optionally PFT-fragmented), file or UDP
  ``edi2eti``   EDI/PFT -> ETI(NI)
  ``eti2iq``    ETI(NI) -> modulated IQ, with optional impairments
  ``eti2audio`` ETI(NI) -> MP2 / DAB+ AAC, PAD labels, MOT objects
  ``eti2mpa``   ETI(NI) -> MP2 (``eti2audio`` restricted to MP2)

All but ``dab2eti`` and ``dabscan`` are host byte work: copies of the JAX
package's commands, identical but for their import lines and the JAX
pins they drop.  ``eti2audio``'s DAB+ RS(120,110) runs the port's
batched decoder (``ops.rs``) on the CPU, as the JAX package pins its own
to the CPU: kB per 120 ms of a service, while the card belongs to the
receiver.
"""
