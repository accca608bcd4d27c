"""Useful model FLOPs of the images answered in the window (encode, and
each image's own tokens through EOS) over the window's seconds at the
card's dense bf16 peak (989 TFLOP/s), in percent."""

from harness import roofline
from harness.readers import useful_flops


def read(run):
    fl = useful_flops(run)
    return fl / (run.seconds * roofline.BF16_FLOPS_PER_S) * 100.0 or None
