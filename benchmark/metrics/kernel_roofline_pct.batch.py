"""threshold_and_label's share of its roofline: the least time of the
window's calls (harness/roofline.py: unpadded frames, 1 B read and 4 B
written per pixel, over the card's HBM rate) over the device time of every
kernel launched inside the harness's span around the wrapper."""
from harness.readers import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec)
