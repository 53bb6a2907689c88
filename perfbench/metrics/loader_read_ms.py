"""Mean milliseconds of a ShardLoader worker's read of one batch: the
data.shard_read entries of the program's span log (the profiler does not
see the loader's threads)."""
from perfbench import spans


def read(v):
    return spans.logged_mean_ms("data.shard_read")
