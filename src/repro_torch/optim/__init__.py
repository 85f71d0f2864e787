from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)
