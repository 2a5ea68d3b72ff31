from .store import (
    CheckpointManager,
    TrainState,
    load_native_checkpoint,
    load_params_only,
    load_state,
    read_state,
    save_state,
)
from .torch_import import (
    import_interlingua_state_dict,
    import_wav2vec2_state_dict,
    load_torch_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "TrainState",
    "load_native_checkpoint",
    "load_params_only",
    "load_state",
    "read_state",
    "save_state",
    "load_torch_checkpoint",
    "import_interlingua_state_dict",
    "import_wav2vec2_state_dict",
]
