"""The detector's model FLOPs (flops.per_image: backbone over the bucket,
RPN, tail and heads on RPN_POST_NMS_TOP_N rois) of the images of the
window's rows after the trace, over their time by the host's clock (the
end of the last traced row to the end of the window), at the card's bf16
dense peak.  The traced rows are left out: the profiler slows the host,
which paces a row."""


def read(ctx):
    from portbench.roofline import BF16_FLOPS_PER_S
    if not ctx['untraced_images'] or ctx['untraced_s'] <= 0:
        return None
    return 100.0 * ctx['flops_per_image'] * ctx['untraced_images'] / (
        ctx['untraced_s'] * BF16_FLOPS_PER_S)
