from .r2l import R2LConvNet, R2LNet, ResBlock, get_activation
from .nerf import NeRFMLP
from . import flops, weights
from .flops import linear_flops, nerf_flops_per_pixel, r2l_flops_per_pixel
from .weights import (conv_state_dict_from_jax, nerf_params_from_state_dict, nerf_state_dict_from_jax,
                      nerf_state_dict_from_params, plain_r2l_state_dict_from_jax,
                      r2l_params_from_state_dict,
                      r2l_state_dict_from_jax, r2l_state_dict_from_params)
