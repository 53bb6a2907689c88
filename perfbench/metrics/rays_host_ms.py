"""Host milliseconds a teacher step in the program's core.get_rays_np span:
a frame's rays made in numpy on the host."""
from perfbench import spans


def read(v):
    return spans.ms_per_request(v, "core.get_rays_np")
