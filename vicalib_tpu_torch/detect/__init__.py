"""Dot-target detection: thresholding, the labelling kernel, conics, PnP."""
