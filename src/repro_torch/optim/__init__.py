from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state, adamw_update,
                                     global_norm, init_opt_state, schedule)

__all__ = ["AdamWConfig", "schedule", "init_opt_state", "abstract_opt_state",
           "global_norm", "adamw_update"]
