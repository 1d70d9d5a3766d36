"""Distributed utilities of the port.  So far: the crash-consistent
checkpoint writer and loader (``distributed.checkpoint``), run from one
process; the launcher's port assignment and rank environment
(``distributed.launch``); and the elastic membership manager
(``distributed.fleet.elastic``), which the cross-process serving fleet
keeps its roster with."""
