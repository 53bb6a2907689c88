"""Host milliseconds a distillation step in the program's data.loader_next
span, ShardLoader's next(): the program's own side of the boundary that
loader_wait_ms reads from the benchmark's pb.fetch."""
from perfbench import spans


def read(v):
    return spans.ms_per_request(v, "data.loader_next")
