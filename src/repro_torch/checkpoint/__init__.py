"""Training-state checkpoints (.npz, atomic writes)."""
from repro_torch.checkpoint.npz import (save_checkpoint, restore_checkpoint,
                                        save_train_state, restore_train_state)
