"""Host-side helpers: the metrics writer and time formatting, the previews,
the analytic FLOP count (`flops`) and the profiling clocks (`profiling`)."""
