"""One reader per per-layer metric, found by the metric's name: each
file gives read(ctx), the number from the `--trace 1` run, or None where
the run holds nothing to read.  The metric's layer, unit and the
end-to-end metric it moves are its BENCHMARK.json entry's.

ctx is `trace.reduce`'s dict (window_s, busy_s, layer_host_s,
layer_count, layer_device_s, entry_device_s) with the traced rows'
`rows`, `chunks`, `images`, the kernel launches `launches` ((entry,
argument summaries) in order), `flops_per_image`, and the rows of the
window after the trace by the host's clock: `untraced_images` and
`untraced_s`."""
