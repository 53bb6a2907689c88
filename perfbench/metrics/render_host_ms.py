"""Host milliseconds a frame in the program's r2l.render_image span: the
camera to kernel 1 queued, while the card waits in the closed loop."""
from perfbench import spans


def read(v):
    return spans.ms_per_request(v, "r2l.render_image")
