"""Host milliseconds a distillation step in the program's train.r2l_step
span, less the waits for the card that start inside it: the host's time to
queue one step."""
from perfbench import spans


def read(v):
    return spans.host_ms_per_request(v, "train.r2l_step")
