"""Distributed utilities of the port.  So far: the crash-consistent
checkpoint writer and loader (``distributed.checkpoint``), run from one
process."""
