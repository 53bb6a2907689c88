"""The readers of the program's spans on made-up events and log entries:
milliseconds a request in a span, the waits for the card that start inside
one, the host's own time, the mean of the span log's worker reads, and None
where the program has no such span."""
import pytest

from efficient_nerf_tpu_torch.utils import profiling
from perfbench import harness, tracing

# a 100 us window of two distillation steps: each step's span holds the
# backward's span, with a wait for the card inside the first one only, and
# a loader wait before each step
HOST = [(tracing.WINDOW_SPAN, 0.0, 100.0),
        (tracing.REQUEST_SPAN, 0.0, 50.0), (tracing.REQUEST_SPAN, 50.0, 100.0),
        ("data.loader_next", 1.0, 5.0), ("data.loader_next", 51.0, 52.0),
        ("train.r2l_step", 6.0, 46.0), ("train.r2l_step", 53.0, 83.0),
        ("r2l_train.backward", 20.0, 40.0), ("r2l_train.backward", 60.0, 70.0),
        ("cudaStreamSynchronize", 21.0, 33.0),
        ("cudaMemcpyAsync", 61.0, 62.0),         # not a wait
        ("cudaStreamSynchronize", 47.0, 49.0),   # outside every step
        ("r2l.render_image", 84.0, 90.0), ("core.get_rays_np", 91.0, 94.0),
        ("train.teacher_step", 95.0, 99.0), ("cudaMemcpy", 96.0, 97.0)]
DEVICE = [("void r2l_train_bwd_kernel<128>(Args)", 22.0, 33.0)]


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def view(host, requests=2):
    return harness.LayerView(tracing.Trace(DEVICE, host, (0.0, 100.0)), requests, {}, {}, {})


@pytest.mark.parametrize("name, want_us", [
    ("render_host_ms", 6.0 / 2),
    ("step_host_ms.distill", (40.0 + 30.0 - 12.0) / 2),
    ("backward_wait_ms", 12.0 / 2),
    ("loader_next_ms", (4.0 + 1.0) / 2),
    ("step_host_ms.teacher", (4.0 - 1.0) / 2),
    ("rays_host_ms", 3.0 / 2),
])
def test_span_readers(name, want_us):
    assert reader(name)(view(HOST)) == pytest.approx(want_us * 1e-3)


@pytest.mark.parametrize("name", ["render_host_ms", "step_host_ms.distill",
                                  "backward_wait_ms", "loader_next_ms",
                                  "step_host_ms.teacher", "rays_host_ms"])
def test_span_readers_without_the_span(name):
    # the benchmark's own spans and the runtime's calls, as a program
    # without spans leaves them
    bare = [h for h in HOST if h[0] == tracing.WINDOW_SPAN or h[0] == tracing.REQUEST_SPAN
            or h[0].startswith("cuda")]
    assert reader(name)(view(bare)) is None


def test_loader_read_ms(monkeypatch):
    log = [profiling.LoggedSpan("data.shard_read", "Thread-1", 1_000_000, 4_000_000, 0),
           profiling.LoggedSpan("data.loader_next", "MainThread", 0, 9_000_000, 0),
           profiling.LoggedSpan("data.shard_read", "Thread-2", 2_000_000, 3_000_000, 1)]
    monkeypatch.setattr(profiling, "spans_logged", lambda: log)
    assert reader("loader_read_ms")(view(HOST)) == pytest.approx((3.0 + 1.0) / 2)
    monkeypatch.setattr(profiling, "spans_logged", lambda: log[1:2])
    assert reader("loader_read_ms")(view(HOST)) is None
    # a program without the span log
    monkeypatch.delattr(profiling, "spans_logged")
    assert reader("loader_read_ms")(view(HOST)) is None
