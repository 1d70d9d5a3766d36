from .save_state_dict import save_state_dict, wait_async_save  # noqa: F401
from .load_state_dict import (load_state_dict, verify_checkpoint,  # noqa: F401
                              CheckpointCorruptError)
