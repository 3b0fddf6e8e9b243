"""Host milliseconds a row spends in _write_and_evaluate (detections.pkl,
the per-class results files and voc_eval's APs), per row."""


def read(ctx):
    n = ctx['layer_count'].get('evaluate', 0)
    return ctx['layer_host_s']['evaluate'] / n * 1e3 if n else None
