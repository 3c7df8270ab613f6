"""The port's models (twin of ``zuds_tpu/models``): the braai real/bogus
CNN's forward pass."""
from .braai import (BraaiD6, init_braai, load_braai, params_from_flax,
                    rb_scores, save_braai)

__all__ = ['BraaiD6', 'init_braai', 'load_braai', 'save_braai',
           'params_from_flax', 'rb_scores']
