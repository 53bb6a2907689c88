"""Host milliseconds a teacher step in the program's train.teacher_step
span, less the waits for the card that start inside it: the host's time to
queue one step."""
from perfbench import spans


def read(v):
    return spans.host_ms_per_request(v, "train.teacher_step")
