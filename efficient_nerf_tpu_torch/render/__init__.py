from .r2l_renderer import (calibrate_serving_scales, make_r2l_forward, r2l_forward_rays,
                           r2l_render_image)
from .renderer import (RenderConfig, RenderResult, make_ray_renderer, render_image,
                       render_rays)
