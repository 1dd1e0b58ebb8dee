"""Host-side helpers: the metrics writer and time formatting, the previews,
the analytic FLOP count (`flops`), the profiling clocks (`profiling`) and
the span recorder (`tracing`)."""
