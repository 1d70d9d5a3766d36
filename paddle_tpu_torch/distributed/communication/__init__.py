"""Process groups, collectives, their watchdog and the differentiated
collectives (port of ``paddle_tpu/distributed/communication``)."""
from .group import (Group, new_group, get_group, is_initialized,  # noqa: F401
                    destroy_process_group, wait, barrier, get_backend)
from .collectives import (all_reduce, all_gather, all_gather_object,  # noqa: F401,E501
                          reduce, broadcast, scatter, reduce_scatter,
                          all_to_all, all_to_all_single, send, recv, isend,
                          irecv, batch_isend_irecv, P2POp, gather, ReduceOp,
                          collective_counts, reset_collective_counts)
from . import stream  # noqa: F401
