from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serialize import load_pytree, save_pytree
