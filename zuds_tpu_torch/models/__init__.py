"""The port's models (twin of ``zuds_tpu/models``): the braai real/bogus
CNN, its forward pass and its training step, and the Adam it trains
with."""
from .adam import Adam, FlatTree, flat_tree
from .braai import (BraaiD6, bce_loss, init_braai, load_braai,
                    make_train_state, opt_state_from_optax,
                    opt_state_to_numpy, params_from_flax, rb_scores,
                    save_braai, train_step)

__all__ = ['BraaiD6', 'init_braai', 'load_braai', 'save_braai',
           'params_from_flax', 'rb_scores', 'make_train_state', 'train_step',
           'bce_loss', 'Adam', 'FlatTree', 'flat_tree', 'opt_state_from_optax',
           'opt_state_to_numpy']
