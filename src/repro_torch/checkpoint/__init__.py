from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, LeafSpec,
                                         latest_step,
                                         read_scalar_leaves,
                                         restore_checkpoint, save_checkpoint)
