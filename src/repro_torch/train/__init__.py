"""Training of the port's LM families: AdamW (``optimizer``) and the train
step (``steps``), ports of ``repro/train``."""
from .optimizer import (AdamWConfig, OptState, adamw_update,  # noqa: F401
                        adamw_update_, global_norm, init_opt_state,
                        opt_state_schema)
from .steps import (TrainConfig, TrainState, init_train_state,  # noqa: F401
                    make_train_step)
