"""Parallelism layer of the PyTorch port.

``channel.channel_parallel_block`` decodes many independent streams as
one batch on one device, with one Viterbi dispatch for all of them.
Time-block sharding across devices is not ported yet (ROADMAP.md).
"""
