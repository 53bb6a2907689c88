"""Host milliseconds a distillation step in waits for the card (stream,
device and event synchronisation, synchronous copies) that start inside the
program's r2l_train.backward span, on the autograd engine's thread."""
from perfbench import spans


def read(v):
    return spans.sync_ms_per_request(v, "r2l_train.backward")
