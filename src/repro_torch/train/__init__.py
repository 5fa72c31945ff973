from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state
from .train_loop import (accumulate_grads, make_init, make_loss_fn,
                         make_train_step, value_and_grad)

__all__ = ["AdamWConfig", "OptState", "accumulate_grads", "adamw_update",
           "init_opt_state", "make_init", "make_loss_fn", "make_train_step",
           "value_and_grad"]
