from .store import load_native_checkpoint
from .torch_import import (
    import_interlingua_state_dict,
    import_wav2vec2_state_dict,
    load_torch_checkpoint,
)

__all__ = [
    "load_native_checkpoint",
    "load_torch_checkpoint",
    "import_interlingua_state_dict",
    "import_wav2vec2_state_dict",
]
