"""Pallas GPU kernels (Triton route).

Each kernel has a plain-XLA reference in :mod:`openintel_tpu.ops` that tests
compare it with bit for bit; on the CPU the kernels run in interpret mode.
"""
