"""device_idle_pct (and each ``device_idle_pct.<part>``, split by the
end-to-end metric it moves): the share of the traced window in which no
kernel, copy or fill ran on the device (the union of the profiler's device
events), in %."""

from bench_port.harness.window import idle_pct as read  # noqa: F401
