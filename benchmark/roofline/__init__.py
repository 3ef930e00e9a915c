"""The yardstick of the benchmark's roofline shares: H100 peaks and, one
file each, the work of a kernel's call counted from its shapes.

Frozen from `siftgpu_tpu_torch/bounds.py` at commit
72032356832fccc0fed74691f2666c2a15816fcf, so that a later change to the
program cannot move the yardstick.  A roofline share is the least time the
card could take for the work (`peaks.least_seconds`) over the device time
the kernel took, in percent.
"""
