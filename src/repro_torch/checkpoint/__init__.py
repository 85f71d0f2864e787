from repro_torch.checkpoint.ckpt import (Checkpointer, latest_step,
                                         latest_steps, load_checkpoint,
                                         save_checkpoint)
