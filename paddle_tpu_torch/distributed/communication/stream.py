"""``communication.stream`` parity: the reference's stream variants of each
collective (communication/stream/) are the collectives themselves here, as
in the JAX package."""
from .collectives import (all_reduce, all_gather, reduce, broadcast,  # noqa: F401
                          scatter, reduce_scatter, all_to_all,
                          all_to_all_single, send, recv)
